"""Hyperparameter search: TPE sampling with median pruning (port of
training/tuner.py, a numpy-only copy: the same seed gives the same
proposals, bit for bit).

The reference uses Optuna's TPE + MedianPruner; this is a self-contained
implementation of the same pair over the same space:

- **TPE sampler** (Bergstra et al. 2011, the algorithm behind Optuna's
  default): completed trials split into the top-γ "good" and remaining
  "bad" sets; candidates are drawn from a Parzen (Gaussian-mixture /
  smoothed-categorical) model of the good set and ranked by the density
  ratio l(x)/g(x). Random sampling is used for the startup trials and is
  selectable with `Study(sampler="random")`.
- **Median pruning**: a trial stops when its intermediate val-AUC falls
  below the median of all finished trials' (completed and pruned)
  intermediate values at the same epoch, as in Optuna's MedianPruner.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

# Search space (reference tuner.py:18-61).
SPACE = {
    "alpha": ("float", 0.25, 1.5),
    "depth_multiplier": ("int", 1, 3),
    "embeddings_size": ("choice", [64, 128, 256]),
    "learning_rate": ("logfloat", 1e-4, 1e-2),
    "dropout_rate": ("float", 0.2, 0.6),
    "batch_size": ("choice", [16, 32, 64]),
    "mixup_probability": ("float", 0.0, 0.5),
    "label_smoothing": ("float", 0.0, 0.1),
    "optimizer": ("choice", ["adam", "adamw", "sgd"]),
    "weight_decay": ("logfloat", 1e-6, 1e-3),
    "gradient_clip_norm": ("choice", [0.0, 1.0, 5.0]),
    "use_se": ("choice", [True, False]),
    "use_inverted_residual": ("choice", [True, False]),
    "use_attention_pooling": ("choice", [True, False]),
}
CONDITIONAL = {
    "se_reduction": ("choice", [4, 8, 16]),        # only if use_se
    "expansion_factor": ("choice", [2, 4, 6]),      # only if use_inverted_residual
}


def sample_params(rng: np.random.Generator) -> dict:
    """Draw one configuration from the search space."""
    def draw(spec):
        kind = spec[0]
        if kind == "float":
            return float(rng.uniform(spec[1], spec[2]))
        if kind == "logfloat":
            return float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
        if kind == "int":
            return int(rng.integers(spec[1], spec[2] + 1))
        if kind == "choice":
            return spec[1][int(rng.integers(len(spec[1])))]
        raise ValueError(kind)

    params = {k: draw(v) for k, v in SPACE.items()}
    if params["use_se"]:
        params["se_reduction"] = draw(CONDITIONAL["se_reduction"])
    if params["use_inverted_residual"]:
        params["expansion_factor"] = draw(CONDITIONAL["expansion_factor"])
    return params


class Pruned(Exception):
    """Raised inside an objective to stop a bad trial early."""


# ------------------------------------------------------------------ TPE

def _numeric_logpdf(x: float, obs: np.ndarray, lo: float, hi: float) -> float:
    """Parzen-window log-density: Gaussians at each observation blended
    with a uniform prior over [lo, hi] (keeps exploration alive)."""
    span = hi - lo
    if span <= 0:
        return 0.0
    uniform = 1.0 / span
    if obs.size == 0:
        return float(np.log(uniform))
    bw = max(span / max(np.sqrt(obs.size), 1.0), 1e-3 * span)
    kernels = np.exp(-0.5 * ((x - obs) / bw) ** 2) / (bw * np.sqrt(2 * np.pi))
    # 1/(n+1) weight on the prior, rest split over kernels.
    dens = (kernels.sum() + uniform) / (obs.size + 1)
    return float(np.log(max(dens, 1e-300)))


def _numeric_sample(rng: np.random.Generator, obs: np.ndarray,
                    lo: float, hi: float) -> float:
    """Draw from the Parzen model of `obs` (or the uniform prior)."""
    if obs.size == 0 or rng.uniform() < 1.0 / (obs.size + 1):
        return float(rng.uniform(lo, hi))
    span = hi - lo
    bw = max(span / max(np.sqrt(obs.size), 1.0), 1e-3 * span)
    center = obs[int(rng.integers(obs.size))]
    return float(np.clip(rng.normal(center, bw), lo, hi))


def _cat_probs(values: list, obs: list) -> np.ndarray:
    """Smoothed categorical probabilities (add-one prior)."""
    counts = np.array([1.0 + sum(1 for o in obs if o == v) for v in values])
    return counts / counts.sum()


def _param_domain(name: str):
    spec = SPACE.get(name) or CONDITIONAL[name]
    kind = spec[0]
    if kind in ("float", "logfloat", "int"):
        lo, hi = float(spec[1]), float(spec[2])
        if kind == "logfloat":
            return kind, np.log(lo), np.log(hi)
        return kind, lo, hi
    return kind, spec[1], None


def _to_internal(name: str, v):
    kind, a, b = _param_domain(name)
    if kind == "logfloat":
        return float(np.log(v))
    if kind in ("float", "int"):
        return float(v)
    return v


def _from_internal(name: str, v):
    kind, a, b = _param_domain(name)
    if kind == "logfloat":
        spec = SPACE.get(name) or CONDITIONAL[name]
        # exp(log(hi)) can overshoot hi by 1 ulp — clamp to the raw bounds.
        return float(min(max(np.exp(v), spec[1]), spec[2]))
    if kind == "int":
        return int(round(v))
    if kind == "float":
        return float(v)
    return v


def tpe_propose(rng: np.random.Generator, completed: list["Trial"],
                gamma: float = 0.25, n_candidates: int = 24) -> dict:
    """One TPE proposal: sample candidates from the good-set model l(x),
    keep the one maximizing log l(x) - log g(x) (maximization study)."""
    ranked = sorted(completed, key=lambda t: -t.value)
    n_good = max(1, int(np.ceil(gamma * len(ranked))))
    good, bad = ranked[:n_good], ranked[n_good:]

    def observations(trials, name):
        vals = [t.params[name] for t in trials if name in t.params]
        return vals

    best_params, best_score = None, -np.inf
    for _ in range(n_candidates):
        cand: dict = {}
        score = 0.0
        for name in list(SPACE) + list(CONDITIONAL):
            if name == "se_reduction" and not cand.get("use_se"):
                continue
            if name == "expansion_factor" and not cand.get("use_inverted_residual"):
                continue
            # Conditional params are SAMPLED from the good-set model but
            # NOT scored: candidates with different active-dimension sets
            # must compare over a common set of terms, or every SE-on
            # candidate eats se_reduction's (often negative) log-ratio and
            # the sampler drifts toward use_se=False regardless of data.
            scored = name in SPACE
            kind, a, b = _param_domain(name)
            g_obs, b_obs = observations(good, name), observations(bad, name)
            if kind in ("float", "logfloat", "int"):
                gi = np.array([_to_internal(name, v) for v in g_obs])
                bi = np.array([_to_internal(name, v) for v in b_obs])
                xi = _numeric_sample(rng, gi, a, b)
                if scored:
                    score += _numeric_logpdf(xi, gi, a, b) - _numeric_logpdf(xi, bi, a, b)
                cand[name] = _from_internal(name, xi)
            else:  # choice
                pg, pb = _cat_probs(a, g_obs), _cat_probs(a, b_obs)
                idx = int(rng.choice(len(a), p=pg))
                if scored:
                    score += float(np.log(pg[idx]) - np.log(pb[idx]))
                cand[name] = a[idx]
        if score > best_score:
            best_params, best_score = cand, score
    return best_params


@dataclass
class Trial:
    number: int
    params: dict
    intermediate: list[float] = field(default_factory=list)
    value: float | None = None
    pruned: bool = False
    study: "Study | None" = None  # backref set by Study.optimize

    def report(self, value: float, step: int, study: "Study | None" = None) -> None:
        """Report an intermediate value; raises Pruned when the median
        pruner says stop (Optuna trial.report + should_prune in one).
        The study argument is optional once Study.optimize set the backref."""
        study = study or self.study
        self.intermediate.append(float(value))
        if study is not None and study.should_prune(step, value):
            self.pruned = True
            raise Pruned()


@dataclass
class Study:
    """TPE (default) or random-search study with median pruning
    (maximization)."""

    seed: int = 0
    n_warmup_trials: int = 3
    n_warmup_steps: int = 1
    sampler: str = "tpe"          # "tpe" | "random"
    n_startup_trials: int = 5     # random trials before TPE kicks in
    trials: list[Trial] = field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.sampler not in ("tpe", "random"):
            raise ValueError(f"unknown sampler: {self.sampler}")

    def _propose(self) -> dict:
        completed = [t for t in self.trials if t.value is not None]
        if self.sampler == "tpe" and len(completed) >= self.n_startup_trials:
            return tpe_propose(self._rng, completed)
        return sample_params(self._rng)

    def should_prune(self, step: int, value: float) -> bool:
        # Optuna MedianPruner semantics: the median is over intermediate
        # values reported at this step by ALL finished trials — completed
        # AND pruned (a pruned trial reported intermediates before it
        # stopped). Excluding pruned trials would ratchet the bar upward
        # from survivors only. The in-flight trial (value None, not
        # pruned) is excluded.
        finished = [t for t in self.trials if t.value is not None or t.pruned]
        if len(finished) < self.n_warmup_trials or step < self.n_warmup_steps:
            return False
        peers = [t.intermediate[step] for t in finished if len(t.intermediate) > step]
        if len(peers) < self.n_warmup_trials:
            return False
        return value < float(np.median(peers))

    def optimize(self, objective: Callable[[Trial], float], n_trials: int) -> None:
        for i in range(n_trials):
            trial = Trial(number=len(self.trials), params=self._propose(),
                          study=self)
            self.trials.append(trial)
            try:
                trial.value = float(objective(trial))
            except Pruned:
                trial.value = None

    @property
    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.value is not None]
        if not done:
            raise RuntimeError("no completed trials")
        return max(done, key=lambda t: t.value)


def run_tuning(objective: Callable[[Trial], float], n_trials: int,
               out_dir: str | Path, seed: int = 0,
               sampler: str = "tpe") -> Trial:
    """Run a study and persist best params JSON (reference tuner.py:223-247)."""
    study = Study(seed=seed, sampler=sampler)
    study.optimize(objective, n_trials)
    best = study.best_trial
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "best_params.json").write_text(json.dumps(
        {"value": best.value, "params": best.params, "trial": best.number}, indent=2))
    return best
