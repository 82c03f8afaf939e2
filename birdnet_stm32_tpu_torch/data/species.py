"""Species list readers and writers (port of data/species.py, a copy)."""

from __future__ import annotations

from pathlib import Path


def load_species_list(path: str | Path) -> list[str]:
    """One species per line; stripped, empties dropped."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Species list not found: {path}")
    species = [line.strip() for line in p.read_text(encoding="utf-8").splitlines()
               if line.strip()]
    if not species:
        raise ValueError(f"Species list is empty: {path}")
    return species


def open_species_list(path: str | Path) -> list[str]:
    """Load, dedupe (first occurrence wins), sort alphabetically."""
    unique = sorted(dict.fromkeys(load_species_list(path)))
    if not unique:
        raise ValueError(f"Species list is empty after deduplication: {path}")
    return unique


def save_species_list(species: list[str], path: str | Path) -> None:
    """One species per line."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("".join(f"{s}\n" for s in species), encoding="utf-8")


def combine_species_lists(
    file_list: list[str | Path],
    output_file: str | Path,
    max_species: int | None = None,
) -> list[str]:
    """Round-robin merge of several lists, dedupe, cap, sort, save."""
    queues = [list(dict.fromkeys(load_species_list(fname))) for fname in file_list]
    combined: list[str] = []
    while any(queues):
        for q in queues:
            if q:
                combined.append(q.pop(0))
    combined = list(dict.fromkeys(combined))
    if max_species is not None:
        combined = combined[:max_species]
    combined.sort()
    save_species_list(combined, output_file)
    return combined
