"""Whitted renders of config1 and config3's whitted variant held against
tpuprt's; split from test_torch_whitted.py so no file holds more than ten
cases. The parametrized module fixture `renders` is test_torch_whitted's,
rendered again for this module.
"""
import numpy as np

from test_torch_whitted import RES, renders


def test_whitted_render_matches_tpuprt(renders):
    """test_torch_render's rule: 99.5% of pixels within atol = rtol =
    1e-4, alpha equal."""
    jrgb, jalpha, trgb, talpha = renders
    assert trgb.shape == (RES, RES, 3) and np.isfinite(trgb).all()
    np.testing.assert_array_equal(talpha, jalpha)
    close_px = np.isclose(trgb, jrgb, atol=1e-4, rtol=1e-4).all(-1)
    assert close_px.mean() >= 0.995, close_px.mean()
    assert trgb.max() > 0.1
