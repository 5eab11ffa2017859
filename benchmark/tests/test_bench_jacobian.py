"""The ``cloud_jacobian`` cell (TOA radiance Jacobians through the Cloud
C.1 deck): a tiny traced and untraced run on the CPU, its float32 control,
the cotangent's law, and the cell at its full size on the card."""

import numpy as np
import pytest

import run
from yardstick import jacobian

# few streams, modes, layers and rows; the 300 moments, the deck and the observation as configured
SMALL = {"config": {"columns": 2, "gpoints": 2, "layers": 8, "nquad": 8, "nleg": 8,
                    "deck": {"layers": 3, "top": [1, 4], "thickness": [1.0, 6.0], "omega": [0.9, 0.999],
                             "droplet_share": [0.7, 1.0]}},
         "traffic": {"nfourier": 4, "sample_rows": 4, "trace_steps": 1}}
SEED = 2**31 + 707


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_agrees_with_the_reference(trace):
    from pythonic_disort_torch.utils import profiling

    profiling.reset()
    result = run.run_cell("cloud_jacobian", SEED, 0.2, trace, device="cpu", overrides=SMALL)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == {"u_err", "grad_err"}
    assert result["checks"]["grad_err"]["value"] < 1e-9 and result["checks"]["u_err"]["value"] < 1e-11
    spec = run.resolve("cloud_jacobian")
    wanted = {m["name"] for m in (spec.per_layer if trace else spec.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if trace:
        # exact and IMS series over the 300 moments, the truncated one over NLeg = 8
        assert result["metrics"]["nt_series_terms_per_chunk"]["value"] == 300 + 8 + 300
        # device extents and kernels: none on the CPU
        for name in ("grad_bvp_ms_per_chunk", "grad_eig_ms_per_chunk", "blocktri_roofline", "jacobi_roofline"):
            assert name not in result["metrics"]
    else:
        assert set(result["metrics"]) == wanted == {"columns_per_s", "setup_s"}
    profiling.reset()


def test_the_float32_control_is_rejected():
    """The plain reference in float32 in the program's place: both readings
    far above the float64 program's, and the gradient's above its limit."""
    from yardstick.probe import Probe

    spec = run.resolve("cloud_jacobian", overrides=SMALL)
    drv = run.load_module(spec.driver).Driver(spec.config, spec.traffic, SEED, "cpu", Probe(lambda: None))
    drv.control(None)
    r = drv.readings()
    assert r["grad_err"]["value"] > 1e-6 and r["u_err"]["value"] > 1e-8


def test_cotangents_repeat_from_the_seed_and_are_standard_normal():
    a, b = jacobian.cotangents(SEED, 4000, 24, 4), jacobian.cotangents(SEED, 4000, 24, 4)
    assert a.shape == (4000, 24, 1, 4) and np.array_equal(a, b)
    assert not np.array_equal(a, jacobian.cotangents(SEED + 1, 4000, 24, 4))
    assert abs(a.mean()) < 0.01 and abs(a.std() - 1.0) < 0.01


@pytest.mark.card
def test_the_cell_on_the_card(card):
    """At its full size for 2 s, traced: correct, kernels 7, 4 and 3 read by
    their rooflines, the backward spans timed, no kernel 1."""
    result = run.run_cell("cloud_jacobian", 2**31 + 99, 2.0, True)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("bvp_roofline", "blocktri_roofline", "jacobi_roofline"):
        assert 0 < m[name] < 100, name
    assert m["grad_bvp_ms_per_chunk"] > 0 and m["grad_eig_ms_per_chunk"] > 0
    assert "eig_roofline" not in m and m["nt_series_terms_per_chunk"] == 648
    assert result["device"]["busy_s"] > 0 and result["device"]["kind"] == card
    assert result["device"]["memory_peak_bytes"] < 72e9
