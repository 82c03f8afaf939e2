"""Dataset discovery: class-folder walks, top-N selection, minority
upsampling, one-hot labels (port of data/dataset.py).

Folders named {noise, silence, background, other} are left out of the
class list, but their files are kept with all-zero labels. numpy only.

WAV always decodes (audio/io.py); mp3, flac, ogg and m4a join the
extensions when the port's libav codec is built (audio/native.py), as in
the JAX package.
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path

import numpy as np

AUDIO_EXTENSIONS = (".wav",)  # always decodable (the RIFF reader)
CODEC_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg", ".m4a")
NOISE_LABELS = frozenset({"noise", "silence", "background", "other"})


def supported_audio_extensions() -> tuple:
    """The extensions the port decodes: the reference's SUPPORTED_AUDIO_EXTS
    when the libav codec is available, else WAV only."""
    from birdnet_stm32_tpu_torch.audio import native

    return CODEC_EXTENSIONS if native.codec_available() else AUDIO_EXTENSIONS


def _class_files(root: str | Path, extensions=None) -> dict[str, list[str]]:
    """Class-folder name -> sorted file list. A file's class is its
    immediate parent directory's name, at any depth."""
    if extensions is None:
        extensions = supported_audio_extensions()
    out: dict[str, list[str]] = defaultdict(list)
    root = Path(root)
    for dirpath, _dirnames, filenames in os.walk(root):
        label = Path(dirpath).name
        if Path(dirpath) == root:
            continue
        for fn in sorted(filenames):
            if fn.lower().endswith(extensions):
                out[label].append(str(Path(dirpath) / fn))
    return dict(out)


def get_classes_with_most_samples(root: str | Path, top_n: int, extensions=None) -> list[str]:
    """The top-N class names by file count (noise folders excluded), sorted."""
    files = _class_files(root, extensions)
    counts = {c: len(fs) for c, fs in files.items() if c.lower() not in NOISE_LABELS}
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return sorted(c for c, _ in ranked[:top_n])


def load_file_paths_from_directory(
    root: str | Path,
    classes: list[str] | None = None,
    max_samples_per_class: int | None = None,
    extensions=None,
    rng: np.random.Generator | None = None,
) -> tuple[list[str], list[str], list[str]]:
    """Walk a dataset directory with one subfolder per class.

    classes restricts to those classes (noise folders are always kept, as
    zero-label files); max_samples_per_class caps each class at a random
    subset drawn from `rng`. Returns (file_paths, file_labels,
    class_names): file_labels holds each file's folder name (possibly a
    noise label), class_names the sorted real classes.
    """
    by_class = _class_files(root, extensions)
    if classes is None:
        class_names = sorted(c for c in by_class if c.lower() not in NOISE_LABELS)
    else:
        class_names = sorted(classes)
    rng = rng or np.random.default_rng()

    paths: list[str] = []
    labels: list[str] = []
    for label, files in sorted(by_class.items()):
        is_noise = label.lower() in NOISE_LABELS
        if not is_noise and label not in class_names:
            continue
        if max_samples_per_class and len(files) > max_samples_per_class:
            files = list(rng.choice(files, size=max_samples_per_class, replace=False))
        paths.extend(files)
        labels.extend([label] * len(files))
    return paths, labels, class_names


def upsample_minority_classes(
    paths: list[str],
    labels: list[str],
    ratio: float = 0.5,
    rng: np.random.Generator | None = None,
) -> tuple[list[str], list[str]]:
    """Repeat files of minority classes (drawn with replacement from `rng`)
    until each has ratio * the largest class's count. Noise files are never
    upsampled."""
    rng = rng or np.random.default_rng()
    by_class: dict[str, list[str]] = defaultdict(list)
    for p, l in zip(paths, labels):
        by_class[l].append(p)
    real_counts = {c: len(fs) for c, fs in by_class.items() if c.lower() not in NOISE_LABELS}
    if not real_counts:
        return list(paths), list(labels)
    target = int(max(real_counts.values()) * ratio)

    out_paths = list(paths)
    out_labels = list(labels)
    for c, files in by_class.items():
        if c.lower() in NOISE_LABELS or len(files) >= target:
            continue
        need = target - len(files)
        extra = rng.choice(files, size=need, replace=True)
        out_paths.extend(extra.tolist())
        out_labels.extend([c] * need)
    return out_paths, out_labels


def one_hot_labels(file_labels: list[str], class_names: list[str]) -> np.ndarray:
    """Folder names -> [N, C] float32; noise labels map to all-zero rows."""
    index = {c: i for i, c in enumerate(class_names)}
    out = np.zeros((len(file_labels), len(class_names)), np.float32)
    for i, label in enumerate(file_labels):
        j = index.get(label)
        if j is not None:
            out[i, j] = 1.0
    return out
