"""Species list readers and writer (port of data/species.py::
load_species_list, open_species_list and save_species_list)."""

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
