"""Tests of the benchmark's harness.  Those marked ``card`` need a CUDA
device and skip without one; run them on the chip with
``python3 -m pytest benchmark/tests -m card``."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.cuda.get_device_name(0)


# Each cell at a size the CPU runs in a second or two: few layers, streams,
# g-points, columns and samples; the widths of the cells on the card are
# those of BENCHMARK.json's configurations.
TINY = {"config": {"columns": 4, "layers": 4, "nquad": 8, "nleg": 8, "nleg_all": 9, "gpoints": 4},
        "traffic": {"chunk_columns": 2, "sample_rows": 8, "trace_steps": 2, "sample_calls": 3}}


def tiny(cell):
    """Overrides that shrink ``cell`` for the CPU."""
    o = {k: dict(v) for k, v in TINY.items()}
    if cell == "lw_flux_temper":
        o["config"].update(band_edges=[10.0, 500.0, 1000.0, 2000.0], gpoints_per_band=2, gpoints=6)
    if cell == "sw_radiance":
        o["traffic"]["nfourier"] = 4
    return o


CELLS = ("sw_flux", "lw_flux_temper", "sw_radiance")


@pytest.fixture
def column_root(tmp_path):
    """A root whose BENCHMARK.json also holds the entries of
    ``benchmark/pending/sw_column.json`` (the benchmark folder linked)."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    pending = json.loads((HERE / "pending" / "sw_column.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += pending[key]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark").symlink_to(HERE)
    return tmp_path
