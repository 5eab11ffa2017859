"""What the sweep drivers share: the pool's chunks, the outputs kept at
the sampled rows, and the reference run over those rows in blocks."""

from __future__ import annotations

import numpy as np

from . import compare, generator

# rows x modes of one reference block: bounds its (rows, modes, layers,
# 2N, 2N) arrays to a few hundred MB at NQuad = 32
REF_BLOCK = 128


class Pool:
    """The cell's seeded inputs, cut into chunks of ``chunk_columns``."""

    def __init__(self, config, traffic, seed):
        self.arrays = generator.pool(config, seed)
        self.chunk_columns = traffic["chunk_columns"]
        self.rows_per_chunk = self.chunk_columns * config["gpoints"]
        self.rows = config["columns"] * config["gpoints"]
        self.chunks = config["columns"] // self.chunk_columns
        rng = generator.sample_rng(seed, 1)
        self.sample = np.sort(rng.choice(self.rows, traffic["sample_rows"], replace=False))
        self.kept = []

    def chunk(self, p):
        lo = p * self.rows_per_chunk
        return {k: v[lo:lo + self.rows_per_chunk] for k, v in self.arrays.items()
                if v.shape[0] == self.rows}

    def keep(self, step, outputs):
        """Keep the sampled rows of step ``step``'s host outputs (each (B, ...))."""
        lo = (step % self.chunks) * self.rows_per_chunk
        sel = self.sample[(self.sample >= lo) & (self.sample < lo + self.rows_per_chunk)]
        if len(sel):
            self.kept.append((step, sel, [np.array(o[sel - lo]) for o in outputs]))

    def fill(self, outputs_of, nfourier):
        """Keep ``outputs_of(rows)`` at every chunk's sampled rows, in place
        of the program's: one pass over the pool."""
        for p in range(self.chunks):
            lo = p * self.rows_per_chunk
            sel = self.sample[(self.sample >= lo) & (self.sample < lo + self.rows_per_chunk)]
            if len(sel):
                self.kept.append((p, sel, list(in_blocks(sel, nfourier, outputs_of))))

    def gathered(self):
        """(steps (K,), pool rows (K,), [outputs (K, ...)]) of every kept
        row, or None."""
        if not self.kept:
            return None
        steps = np.concatenate([np.full(len(r), s) for s, r, _ in self.kept])
        rows = np.concatenate([r for _, r, _ in self.kept])
        outs = [np.concatenate([o[i] for _, _, o in self.kept]) for i in range(len(self.kept[0][2]))]
        return steps, rows, outs


def in_blocks(rows, nfourier, fn):
    """``fn(block of rows)`` over ``rows`` in blocks of REF_BLOCK / nfourier
    rows; each result (a tuple of arrays with a leading row axis) joined."""
    step = max(1, REF_BLOCK // nfourier)
    parts = [fn(rows[i:i + step]) for i in range(0, len(rows), step)]
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(len(parts[0])))


def flux_reading(pool, reference_rows, limit, pole):
    """The ``flux_err`` reading of a flux sweep: every kept row's three
    fluxes against ``reference_rows(rows) -> (fup, fdn, fdir, distance)``."""
    got = pool.gathered()
    if got is None:
        return compare.reading(float("inf"), limit)
    steps, rows, outs = got
    uniq, inv = np.unique(rows, return_inverse=True)
    fup, fdn, fdir, dist = in_blocks(uniq, 1, reference_rows)
    ref = np.stack([fup, fdn, fdir], axis=1)[inv]
    err = compare.conditioned(compare.row_errors(np.stack(outs, axis=1), ref), dist[inv], pole)
    compare.report("flux_err", err, steps, rows, dist[inv])
    return compare.reading(err.max(), limit)
