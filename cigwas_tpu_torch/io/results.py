"""Per-block skeleton result containers and their on-disk formats.

Equivalents of `ReducedGCS` / `ReducedGC` (`parent_set.h:30-140`): the
`.mdim/.ixs/.adj/.corr[/.sep]` fileset that every cusk/cuskss stage writes and
that the Python merge/sepselect stages read back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cigwas_tpu_torch.io.binary import (
    read_floats_from_binary,
    read_ints_from_binary,
    write_floats_to_binary,
    write_ints_to_binary,
)


def _write_mdim(base: str, num_var: int, num_phen: int, max_level: int) -> None:
    with open(base + ".mdim", "w") as fout:
        fout.write(f"{num_var}\t{num_phen}\t{max_level}\n")


def load_mdim(base: str) -> list[int]:
    with open(base + ".mdim") as fin:
        return [int(f) for f in fin.readline().split()]


@dataclass
class ReducedGCS:
    """Adjacency + correlations + separation sets on a variable subset.

    S has shape (num_var, num_var, max_level), entries are new-space variable
    indices padded with -1.
    """

    num_var: int
    num_phen: int
    max_level: int
    new_to_old_indices: np.ndarray  # (num_var,) int32
    G: np.ndarray  # (num_var, num_var) int32
    C: np.ndarray  # (num_var, num_var) float32
    S: np.ndarray  # (num_var, num_var, max_level) int32

    def num_markers(self) -> int:
        return self.num_var - self.num_phen

    def to_file(self, base: str) -> None:
        _write_mdim(base, self.num_var, self.num_phen, self.max_level)
        write_ints_to_binary(self.new_to_old_indices, base + ".ixs")
        write_ints_to_binary(self.G, base + ".adj")
        write_floats_to_binary(self.C, base + ".corr")
        write_ints_to_binary(self.S, base + ".sep")

    @classmethod
    def from_file(cls, base: str) -> "ReducedGCS":
        num_var, num_phen, max_level = load_mdim(base)
        return cls(
            num_var=num_var,
            num_phen=num_phen,
            max_level=max_level,
            new_to_old_indices=read_ints_from_binary(base + ".ixs"),
            G=read_ints_from_binary(base + ".adj").reshape(num_var, num_var),
            C=read_floats_from_binary(base + ".corr").reshape(num_var, num_var),
            S=read_ints_from_binary(base + ".sep").reshape(num_var, num_var, max_level),
        )


@dataclass
class ReducedGC:
    """Adjacency + correlations + effective-sample-size matrix (cuskss paths).

    The `.sep` file is absent; S here is the (num_var, num_var) ESS matrix,
    which is carried between stages but not written (`parent_set.h:99-108`).
    """

    num_var: int
    num_phen: int
    max_level: int
    new_to_old_indices: np.ndarray
    G: np.ndarray  # (num_var, num_var) int32
    C: np.ndarray  # (num_var, num_var) float32
    S: np.ndarray  # (num_var, num_var) float32 (ESS)

    def num_markers(self) -> int:
        return self.num_var - self.num_phen

    def to_file(self, base: str) -> None:
        _write_mdim(base, self.num_var, self.num_phen, self.max_level)
        write_ints_to_binary(self.new_to_old_indices, base + ".ixs")
        write_ints_to_binary(self.G, base + ".adj")
        write_floats_to_binary(self.C, base + ".corr")

    @classmethod
    def from_file(cls, base: str, ess: float = np.nan) -> "ReducedGC":
        num_var, num_phen, max_level = load_mdim(base)
        return cls(
            num_var=num_var,
            num_phen=num_phen,
            max_level=max_level,
            new_to_old_indices=read_ints_from_binary(base + ".ixs"),
            G=read_ints_from_binary(base + ".adj").reshape(num_var, num_var),
            C=read_floats_from_binary(base + ".corr").reshape(num_var, num_var),
            S=np.full((num_var, num_var), ess, dtype=np.float32),
        )
