"""Deterministic synthetic token pipeline with grid-placed shards (the
counterpart of ``repro.data.pipeline``).

The dataset is a set of shards ("files" in the paper's sense) registered in
the :class:`~repro_torch.grid.datagrid.DataGridService`. Every training
step issues one shard-read job; the data-aware scheduler sends it to the
site already holding the most shard bytes, and HRS replicates hot shards
within a region before the cross-region path is touched. The token
contents are synthesized deterministically from (seed, shard, index), so
any host can materialize its assignment. Batches stay numpy arrays, the
reference's exactly; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..grid.datagrid import DataGridService


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 64
    shard_bytes: float = 512e6
    seed: int = 0


def shard_name(i: int) -> str:
    return f"dataset/shard{i:05d}"


class SyntheticShardedDataset:
    """tokens(shard, index) is a pure function, deterministic everywhere.

    Sequences follow a per-shard affine recurrence x_{t+1} = (a x_t + b)
    mod K (K <= vocab), so the stream is learnable (a model trained on it
    drives next-token loss well below ln K) while staying reproducible
    from (seed, shard, index) alone."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        self.k = min(cfg.vocab, 251)

    def tokens(self, shard: int, index: int) -> np.ndarray:
        cfg = self.cfg
        srng = np.random.default_rng(np.uint64(cfg.seed * 9176 + shard))
        a = int(srng.integers(1, self.k))
        b = int(srng.integers(0, self.k))
        rng = np.random.default_rng(
            np.uint64(cfg.seed * 1_000_003 + shard * 7919 + index))
        toks = np.empty((cfg.seq_len + 1,), np.int32)
        toks[0] = rng.integers(0, self.k)
        for t in range(cfg.seq_len):
            toks[t + 1] = (a * int(toks[t]) + b) % self.k
        return toks


class GridDataLoader:
    """Yields (batch, placement_stats) per step.

    Each step draws ``global_batch`` sequences round-robin over shards; the
    shard-read job is routed through the DataGridService so replica
    placement follows the paper's policy.
    """

    def __init__(self, dataset: SyntheticShardedDataset,
                 grid: DataGridService, *, register: bool = True) -> None:
        self.ds = dataset
        self.grid = grid
        cfg = dataset.cfg
        if register:
            n_sites = grid.topology.n_sites
            for i in range(cfg.n_shards):
                grid.register(shard_name(i), cfg.shard_bytes,
                              master_site=(i * 3) % n_sites)
        self._step = 0

    def next_batch(self):
        cfg = self.ds.cfg
        step = self._step
        self._step += 1
        shards = [(step * cfg.global_batch + b) % cfg.n_shards
                  for b in range(cfg.global_batch)]
        uniq = sorted(set(shards))
        site, stats = self.grid.place_job([shard_name(s) for s in uniq],
                                          length=1.0)
        toks = np.stack([self.ds.tokens(s, step) for s in shards])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        self.grid.complete_job(site)
        return batch, {"site": site, "transfers": stats}
