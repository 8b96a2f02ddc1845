"""Native hyperparameter-search engine (sqlite-backed, multi-worker safe): a
copy of ``sbgm_danra_tpu/sweep/study.py`` (stdlib, sqlite3 and numpy), so that
either package's workers read and write the same study file.

The reference relies on Optuna (sbgm/sweep/run_optuna.py: GPSampler +
SuccessiveHalvingPruner over a sqlite study, one trial per SLURM array task).
Optuna is not available in this image, so the same capabilities are implemented
natively:

- ``Study``: sqlite storage with ``load_if_exists`` semantics, so N concurrent
  workers (SLURM array tasks / separate hosts) can share one study file — the
  sharding pattern of run_optuna.py:15-19, 278-286;
- samplers: uniform random and scrambled-Halton quasirandom over the same
  parameter kinds Optuna exposes (float/log-float/int/categorical);
- ``SuccessiveHalvingPruner``: rung-based early stopping on intermediate
  values, matching Optuna's reduction-factor semantics.

Trials record params, per-step intermediate values, state and final value.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sqlite3
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

_SCHEMA = """
CREATE TABLE IF NOT EXISTS trials (
    trial_id INTEGER PRIMARY KEY AUTOINCREMENT,
    state TEXT NOT NULL DEFAULT 'running',
    value REAL,
    params TEXT NOT NULL DEFAULT '{}',
    intermediate TEXT NOT NULL DEFAULT '[]',
    units TEXT NOT NULL DEFAULT '[]',
    created REAL,
    finished REAL
);
CREATE TABLE IF NOT EXISTS study_meta (
    key TEXT PRIMARY KEY,
    value TEXT
);
"""


class TrialPruned(Exception):
    """Raised inside an objective to stop an unpromising trial."""


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


class RandomSampler:
    def __init__(self, seed: int = 0):
        import numpy as np

        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self.last_unit: float = 0.0  # unit coord of the most recent suggestion

    def _unit(self, trial_id: int, dim: int) -> float:
        return float(self._rng.random())

    def suggest_float(self, trial_id, dim, low, high, log=False) -> float:
        u = self._unit(trial_id, dim)
        self.last_unit = u
        if log:
            return math.exp(math.log(low) + u * (math.log(high) - math.log(low)))
        return low + u * (high - low)

    def suggest_int(self, trial_id, dim, low, high) -> int:
        return min(int(self.suggest_float(trial_id, dim, low, high + 1)), high)

    def suggest_categorical(self, trial_id, dim, choices: Sequence) -> Any:
        u = self._unit(trial_id, dim)
        self.last_unit = u
        return choices[min(int(u * len(choices)), len(choices) - 1)]


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53]


def _halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class HaltonSampler(RandomSampler):
    """Scrambled Halton: low-discrepancy coverage of the search space —
    better space-filling than uniform random for small trial budgets."""

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        import numpy as np

        self._shift = np.random.default_rng(seed).random(len(_PRIMES))

    def _unit(self, trial_id: int, dim: int) -> float:
        base = _PRIMES[dim % len(_PRIMES)]
        u = _halton(trial_id + 1, base) + float(self._shift[dim % len(_PRIMES)])
        return u % 1.0


class GPSampler(HaltonSampler):
    """Gaussian-process expected-improvement sampler (the reference uses
    Optuna's GPSampler, run_optuna.py:278-286).

    Completed trials' unit-cube coordinates and values fit an RBF-kernel GP;
    each new trial maximizes expected improvement over random candidates.
    Falls back to scrambled Halton until ``n_startup`` observations exist
    (completed or pruned-with-value trials — see Study._observed_units; and
    for any dimensions beyond those seen in the history).
    """

    def __init__(self, seed: int = 0, n_startup: int = 8, n_candidates: int = 512,
                 length_scale: float = 0.25, noise: float = 1e-4, xi: float = 0.01):
        super().__init__(seed)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self._proposal: Optional[List[float]] = None

    def begin_trial(self, trial_id: int, history: List[tuple]) -> None:
        """history: [(unit_vector, value), ...] observations — completed
        trials plus pruned trials' last reported values (Study._observed_units)."""
        import numpy as np

        self._proposal = None
        usable = [(u, v) for u, v in history if u and v is not None]
        if len(usable) < self.n_startup:
            return
        dims = min(len(u) for u, _ in usable)
        x = np.asarray([u[:dims] for u, _ in usable], dtype=np.float64)
        y = np.asarray([v for _, v in usable], dtype=np.float64)
        y_mean, y_std = y.mean(), max(y.std(), 1e-12)
        yn = (y - y_mean) / y_std

        def rbf(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale**2)

        k = rbf(x, x) + self.noise * np.eye(len(x))
        try:
            chol = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, yn))
        rng = np.random.default_rng((self._seed, trial_id))
        cand = rng.random((self.n_candidates, dims))
        ks = rbf(cand, x)
        mu = ks @ alpha
        vsolve = np.linalg.solve(chol, ks.T)
        var = np.maximum(1.0 - (vsolve**2).sum(0), 1e-12)
        sd = np.sqrt(var)
        best = yn.min()
        z = (best - mu - self.xi) / sd
        # Phi and phi of the standard normal
        from math import erf, pi

        phi = np.exp(-0.5 * z**2) / np.sqrt(2 * pi)
        cdf = 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))
        ei = (best - mu - self.xi) * cdf + sd * phi
        self._proposal = [float(c) for c in cand[int(np.argmax(ei))]]

    def _unit(self, trial_id: int, dim: int) -> float:
        if self._proposal is not None and dim < len(self._proposal):
            return self._proposal[dim]
        return super()._unit(trial_id, dim)


# ---------------------------------------------------------------------------
# Pruner
# ---------------------------------------------------------------------------


class SuccessiveHalvingPruner:
    """Prune a trial whose intermediate value is outside the top 1/eta of
    completed values at the same rung (min_resource * eta^k steps)."""

    def __init__(self, min_resource: int = 1, reduction_factor: int = 4):
        self.min_resource = min_resource
        self.eta = reduction_factor

    def rungs(self, step: int) -> List[int]:
        out = []
        r = self.min_resource
        while r <= step:
            out.append(r)
            r *= self.eta
        return out

    def should_prune(self, step: int, value: float, peers: List[List[tuple]]) -> bool:
        """peers: list of other trials' (step, value) histories."""
        rungs = self.rungs(step)
        if not rungs:
            return False
        rung = rungs[-1]
        at_rung = []
        for hist in peers:
            vals = [v for s, v in hist if s >= rung]
            if vals:
                at_rung.append(min(vals))
        if len(at_rung) < self.eta:
            return False
        at_rung.sort()
        k = max(1, len(at_rung) // self.eta)
        return value > at_rung[k - 1]


# ---------------------------------------------------------------------------
# Study
# ---------------------------------------------------------------------------


class Trial:
    def __init__(self, study: "Study", trial_id: int):
        self.study = study
        self.trial_id = trial_id
        self.params: Dict[str, Any] = {}
        self._dim = 0
        self._history: List[tuple] = []
        self._units: List[float] = []

    def _next_dim(self) -> int:
        d = self._dim
        self._dim += 1
        return d

    def suggest_float(self, name, low, high, log=False) -> float:
        v = self.study.sampler.suggest_float(self.trial_id, self._next_dim(), low, high, log)
        self._units.append(self.study.sampler.last_unit)
        self.params[name] = v
        return v

    def suggest_int(self, name, low, high) -> int:
        v = self.study.sampler.suggest_int(self.trial_id, self._next_dim(), low, high)
        self._units.append(self.study.sampler.last_unit)
        self.params[name] = v
        return v

    def suggest_categorical(self, name, choices) -> Any:
        v = self.study.sampler.suggest_categorical(self.trial_id, self._next_dim(), list(choices))
        self._units.append(self.study.sampler.last_unit)
        self.params[name] = v
        return v

    def report(self, value: float, step: int) -> None:
        self._history.append((step, float(value)))
        self.study._update_intermediate(self.trial_id, self._history, self.params)

    def should_prune(self, step: Optional[int] = None) -> bool:
        if self.study.pruner is None or not self._history:
            return False
        step = step if step is not None else self._history[-1][0]
        value = self._history[-1][1]
        peers = self.study._peer_histories(exclude=self.trial_id)
        return self.study.pruner.should_prune(step, value, peers)


class Study:
    def __init__(
        self,
        storage_path: str,
        sampler: Optional[RandomSampler] = None,
        pruner: Optional[SuccessiveHalvingPruner] = None,
        direction: str = "minimize",
        load_if_exists: bool = True,
    ):
        if direction != "minimize":
            raise ValueError("Only 'minimize' is supported (DSM val loss)")
        self.storage_path = storage_path
        if not load_if_exists and os.path.exists(storage_path):
            raise FileExistsError(storage_path)
        os.makedirs(os.path.dirname(os.path.abspath(storage_path)), exist_ok=True)
        self.sampler = sampler or RandomSampler()
        self.pruner = pruner
        with self._conn() as con:
            con.executescript(_SCHEMA)

    def _conn(self) -> sqlite3.Connection:
        con = sqlite3.connect(self.storage_path, timeout=60.0)
        con.execute("PRAGMA journal_mode=WAL")
        return con

    # -- trial lifecycle --------------------------------------------------

    def _create_trial(self) -> Trial:
        with self._conn() as con:
            cur = con.execute(
                "INSERT INTO trials (state, created) VALUES ('running', ?)",
                (time.time(),),
            )
            trial_id = cur.lastrowid
        return Trial(self, trial_id - 1)  # 0-based ids for sampler sequences

    def _update_intermediate(self, trial_id: int, history, params) -> None:
        with self._conn() as con:
            con.execute(
                "UPDATE trials SET intermediate=?, params=? WHERE trial_id=?",
                (json.dumps(history), json.dumps(params), trial_id + 1),
            )

    def _finish(
        self, trial_id: int, state: str, value: Optional[float], params,
        units: Optional[List[float]] = None,
    ) -> None:
        with self._conn() as con:
            con.execute(
                "UPDATE trials SET state=?, value=?, params=?, units=?, finished=? "
                "WHERE trial_id=?",
                (state, value, json.dumps(params), json.dumps(units or []),
                 time.time(), trial_id + 1),
            )

    def _observed_units(self) -> List[tuple]:
        """(unit_vector, value) observations for the sampler: completed trials
        AND pruned trials carrying their last reported value. Excluding pruned
        trials starves GP-EI under aggressive pruning — in the r5 fair trial
        the production SuccessiveHalving pruner killed 8/14 trials, completed
        observations never reached n_startup, and the GP phase degenerated to
        its quasirandom fallback for every proposal (BASELINE HPO addendum).
        A prune is a noisy (reduced-fidelity, rung-1) but directionally valid
        observation of a bad region."""
        with self._conn() as con:
            rows = con.execute(
                "SELECT units, value FROM trials "
                "WHERE value IS NOT NULL AND state IN ('complete', 'pruned')"
            ).fetchall()
        return [(json.loads(r[0]), r[1]) for r in rows]

    def _peer_histories(self, exclude: int) -> List[List[tuple]]:
        with self._conn() as con:
            rows = con.execute(
                "SELECT intermediate FROM trials WHERE trial_id != ?", (exclude + 1,)
            ).fetchall()
        return [[tuple(p) for p in json.loads(r[0])] for r in rows if r[0] != "[]"]

    # -- public API ---------------------------------------------------------

    def optimize(self, objective: Callable[[Trial], float], n_trials: int) -> None:
        for _ in range(n_trials):
            trial = self._create_trial()
            if hasattr(self.sampler, "begin_trial"):
                self.sampler.begin_trial(trial.trial_id, self._observed_units())
            try:
                value = objective(trial)
                self._finish(
                    trial.trial_id, "complete", float(value), trial.params, trial._units
                )
            except TrialPruned:
                last = trial._history[-1][1] if trial._history else None
                self._finish(trial.trial_id, "pruned", last, trial.params, trial._units)
            except Exception:
                self._finish(trial.trial_id, "failed", None, trial.params, trial._units)
                raise

    @property
    def trials(self) -> List[Dict]:
        with self._conn() as con:
            rows = con.execute(
                "SELECT trial_id, state, value, params, intermediate FROM trials"
            ).fetchall()
        return [
            {
                "trial_id": r[0] - 1,
                "state": r[1],
                "value": r[2],
                "params": json.loads(r[3]),
                "intermediate": json.loads(r[4]),
            }
            for r in rows
        ]

    @property
    def best_trial(self) -> Dict:
        done = [t for t in self.trials if t["state"] == "complete" and t["value"] is not None]
        if not done:
            raise ValueError("No completed trials")
        return min(done, key=lambda t: t["value"])
