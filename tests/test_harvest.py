"""Golden parity tests for the Harvest F0 estimator, stage by stage.

Slow tier: running the full harvest program on the XLA CPU backend costs
~8 min compile + ~8 min f64 run on a 1-core box (the dense (candidate x
frame) refinement fan-out is matmul-shaped compute).  Run with
``pytest -m slow``."""
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def hv(mwm):
    from world_tpu.f0.harvest import harvest

    fs, x = mwm
    return {k: np.asarray(v)
            for k, v in harvest(x, fs, debug_outputs=True).items()}


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN / "harvest.npz")


def test_downsample_matches(mwm, g):
    from world_tpu.f0.harvest import downsample
    import jax.numpy as jnp

    fs, x = mwm
    y, actual_fs = downsample(jnp.asarray(x), fs)
    ref = g["y_decimated"]
    assert y.shape == ref.shape
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-12)


def test_no_capacity_overflow_on_fixture(hv):
    """The static tables must hold the canonical fixture with headroom."""
    assert not bool(hv["_refine_overflow"])
    assert not bool(hv["_section_overflow"])


def test_raw_candidates_match(hv, g):
    ref = g["raw_f0_candidates"].astype(np.float64)  # stored f32
    got = hv["_raw_candidates"]
    assert got.shape == ref.shape
    agree = np.isclose(got, ref, rtol=2e-5, atol=1e-2)
    assert agree.mean() > 0.999, f"raw agreement {agree.mean()}"


def test_detected_candidates_match(hv, g):
    ref = g["f0_candidates_detected"]
    got = hv["_cands_detected"]
    assert got.shape == ref.shape
    agree = np.isclose(got, ref, rtol=1e-6, atol=1e-4)
    assert agree.mean() > 0.999, f"detect agreement {agree.mean()}"


def test_overlap_matches(hv, g):
    ref = g["f0_candidates_overlap"]
    got = hv["_cands_overlap"]
    # reference allocates rows = 7 * measured_count; ours = 7 * 14 (static).
    # rows map blockwise: ref block i (mc_ref rows) == our block i's first
    # mc_ref rows; our extra rows must be ~zero.
    mc_ref = ref.shape[0] // 7
    mc = got.shape[0] // 7
    for i in range(7):
        blk_ref = ref[i * mc_ref:(i + 1) * mc_ref]
        blk_got = got[i * mc:i * mc + mc_ref]
        agree = np.isclose(blk_got, blk_ref, rtol=1e-6, atol=1e-4)
        assert agree.mean() > 0.999, f"overlap block {i} agreement {agree.mean()}"
        extra = got[i * mc + mc_ref:(i + 1) * mc]
        if i != 0:  # block 0 row 0 holds the reference's row-copy quirk
            assert np.abs(extra).max() < 1e-9


def test_refined_candidates_match(hv, g):
    ref = g["f0_candidates_refined"]
    ref_s = g["f0_scores_refined"]
    mc_ref = ref.shape[0] // 7
    got = hv["_cands_refined"]
    got_s = hv["_scores_refined"]
    mc = got.shape[0] // 7
    for i in range(7):
        blk_ref = ref[i * mc_ref:(i + 1) * mc_ref]
        blk_got = got[i * mc:i * mc + mc_ref]
        agree = np.isclose(blk_got, blk_ref, rtol=1e-5, atol=1e-3)
        assert agree.mean() > 0.995, f"refine block {i} agreement {agree.mean()}"
        blk_ref_s = ref_s[i * mc_ref:(i + 1) * mc_ref]
        blk_got_s = got_s[i * mc:i * mc + mc_ref]
        agree_s = np.isclose(blk_got_s, blk_ref_s, rtol=1e-3, atol=1e-2)
        assert agree_s.mean() > 0.99, f"score block {i} agreement {agree_s.mean()}"


def test_clean_candidates_match(hv, g):
    ref = g["f0_candidates_clean"]
    mc_ref = ref.shape[0] // 7
    got = hv["_cands_clean"]
    mc = got.shape[0] // 7
    for i in range(7):
        blk_ref = ref[i * mc_ref:(i + 1) * mc_ref]
        blk_got = got[i * mc:i * mc + mc_ref]
        agree = np.isclose(blk_got, blk_ref, rtol=1e-5, atol=1e-3)
        assert agree.mean() > 0.995, f"clean block {i} agreement {agree.mean()}"


def test_contour_steps_match(hv, g):
    for stage, key in [("_f0_base", "f0_base"), ("_f0_step1", "f0_step1"),
                       ("_f0_step2", "f0_step2"), ("_f0_step3", "f0_step3"),
                       ("_f0_step4", "f0_step4")]:
        ref = g[key]
        got = hv[stage]
        agree = np.isclose(got, ref, rtol=1e-5, atol=1e-3)
        assert agree.mean() > 0.99, f"{stage} agreement {agree.mean()}"


def test_smoothed_and_output_match(hv, g):
    agree = np.isclose(hv["_smoothed"], g["smoothed_f0"], rtol=1e-5, atol=1e-3)
    assert agree.mean() > 0.99, f"smoothed agreement {agree.mean()}"
    vuv_agree = (hv["vuv"] == g["vuv"]).mean()
    assert vuv_agree > 0.99, f"vuv agreement {vuv_agree}"
    both = (hv["vuv"] == 1) & (g["vuv"] == 1)
    rmse = np.sqrt(np.mean((hv["f0"][both] - g["f0"][both]) ** 2))
    assert rmse < 0.2, f"voiced F0 RMSE {rmse} Hz"
