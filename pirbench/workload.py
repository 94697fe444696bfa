"""The one traffic generator: it reads a mix's parameters from
traffic/<name>.json and draws, from the seed, which records the clients
ask for and in what order.

A mix's file holds:
- loop: "closed" (each client sends its next query when its previous one
  is answered); the port has no serving loop that batches arrivals, so an
  open loop is refused;
- batch: the queries served together in one step (1: one client, each
  query served alone; B: B clients whose queries are always served
  together);
- pool: the number of distinct queries made before the run, each for a
  record drawn without replacement from the whole database (cycled if the
  window asks for more);
- warm_steps: steps served in set-up, before the window;
- trace_steps: steps served under the profiler in a traced run;
- chain_runs: queries served through the stage chain in a traced run (0:
  none; the first of them captures the chain and is not read).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    loop: str
    batch: int
    pool: int
    warm_steps: int
    trace_steps: int
    chain_runs: int

    @classmethod
    def load(cls, name: str, folder: Path = HERE / "traffic") -> "Traffic":
        fields = json.loads((folder / f"{name}.json").read_text())
        fields.pop("why", None)
        t = cls(name=name, **fields)
        if t.loop != "closed":
            raise ValueError(f"traffic {name}: loop {t.loop!r}; the program "
                             "serves closed loops only")
        if t.batch < 1 or t.pool < t.batch:
            raise ValueError(f"traffic {name}: batch {t.batch}, pool {t.pool}")
        return t

    def pool_indices(self, total_n: int, seed: int) -> np.ndarray:
        """The pool's record indices: distinct while the database has
        enough records, in an order drawn from the seed."""
        rng = np.random.default_rng(seed)
        reps = -(-self.pool // total_n)
        return np.concatenate([rng.permutation(total_n)
                               for _ in range(reps)])[:self.pool]

    def step(self, k: int) -> list[int]:
        """The pool positions of step k's queries (the pool cycled)."""
        return [(k * self.batch + j) % self.pool for j in range(self.batch)]
