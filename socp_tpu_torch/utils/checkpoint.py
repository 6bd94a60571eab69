"""Solver-state snapshot / resume: a copy of `socp_tpu/utils/checkpoint.py`
(NumPy only).

The state is a handful of arrays and an iteration counter, so a snapshot
is a small npz file with the reference's keys (`x`, `y`, `s`, `z`,
`iteration`, `meta_<key>`): a snapshot that either package writes loads
in the other.  `parallel/admm.py` keeps an ADMM run's state in it:
x = w_bar, y = u, the round in `iteration`, and rho and the warm iterates
in `meta`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SolverCheckpoint:
    """A resumable snapshot of an (interrupted) solve or ADMM outer loop."""

    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    z: np.ndarray
    iteration: int
    meta: dict = dataclasses.field(default_factory=dict)

    def save(self, path: str) -> None:
        np.savez(
            path,
            x=self.x, y=self.y, s=self.s, z=self.z,
            iteration=np.asarray(self.iteration),
            **{f"meta_{k}": np.asarray(v) for k, v in self.meta.items()},
        )

    @classmethod
    def load(cls, path: str) -> "SolverCheckpoint":
        with np.load(path) as f:
            meta = {
                k[len("meta_"):]: f[k] for k in f.files if k.startswith("meta_")
            }
            return cls(
                x=f["x"], y=f["y"], s=f["s"], z=f["z"],
                iteration=int(f["iteration"]), meta=meta,
            )

    def to_pytree(self) -> dict:
        return {"x": self.x, "y": self.y, "s": self.s, "z": self.z,
                "iteration": self.iteration}
