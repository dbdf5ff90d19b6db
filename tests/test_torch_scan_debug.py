"""The debug integrator's scan Li per channel set, held against tpuprt on
test_torch_scan.py's scenes; split from test_torch_scan.py so no file holds
more than ten cases. The module fixture `scenes` is test_torch_scan's,
built again for this module.
"""
import pytest

from test_torch_scan import per_sample_close, port_li, scenes, tpuprt_li
from tpuprt_torch.integrators import debug as tdebug


@pytest.mark.parametrize("channels", [
    ("u", "v", "hit"), ("nx", "ny", "nz"), ("snx", "sny", "snz"),
    ("t", "one", "matid"), ("zero",)])
def test_debug_li_matches_tpuprt(scenes, channels):
    """Every channel of debug.li (tpuprt/integrators/debug.py:16-45); a
    short tuple is padded with "zero"."""
    jscene, jopts, tscene, topts, cam = scenes
    assert set(tdebug.CHANNELS) >= set(channels)
    kw = dict(integrator="debug", debug_channels=channels)
    per_sample_close(tpuprt_li(jscene, jopts._replace(**kw), cam),
                     port_li(tscene, topts._replace(**kw), cam))
