"""The ``cloud_radiance`` cell (a Cloud C.1 deck at 300 Legendre moments):
a tiny traced and untraced run on the CPU, and the cell at its full size on
the card."""

import pytest

import run

# few streams, modes, layers and rows; the 300 moments and the deck as configured
SMALL = {"config": {"columns": 2, "gpoints": 2, "layers": 8, "nquad": 8, "nleg": 8,
                    "deck": {"layers": 3, "top": [1, 4], "thickness": [1.0, 6.0], "omega": [0.9, 0.999],
                             "droplet_share": [0.7, 1.0]}},
         "traffic": {"nfourier": 4, "sample_rows": 4, "trace_steps": 1}}


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_agrees_with_the_reference(trace):
    from pythonic_disort_torch.utils import profiling

    profiling.reset()
    result = run.run_cell("cloud_radiance", 2**31 + 505, 0.2, trace, device="cpu", overrides=SMALL)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    spec = run.resolve("cloud_radiance")
    wanted = {m["name"] for m in (spec.per_layer if trace else spec.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if trace:
        # the exact and the IMS series over the 300 moments, the truncated one over NLeg = 8
        assert result["metrics"]["nt_series_terms_per_chunk"]["value"] == 300 + 8 + 300
        assert "nt_series_ms_per_chunk" not in result["metrics"]        # a device extent: none on the CPU
    else:
        assert set(result["metrics"]) == wanted
    profiling.reset()


@pytest.mark.card
def test_the_cell_on_the_card(card):
    """At its full size for 2 s, traced: correct, kernels 1 and 7 read by
    their rooflines, and the NT series counted."""
    result = run.run_cell("cloud_radiance", 2**31 + 99, 2.0, True)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["bvp_roofline"] < 100 and 0 < m["eig_roofline"] < 100
    assert m["nt_series_terms_per_chunk"] == 648 and m["nt_series_ms_per_chunk"] > 0
    assert result["device"]["busy_s"] > 0 and result["device"]["kind"] == card
