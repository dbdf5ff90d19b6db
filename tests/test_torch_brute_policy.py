"""The accelerator policy of the port's builder, as tpuprt's
(tpuprt/scene/build.py:755-779): which accelerator a scene file gets by its
Accelerator statement and its prim count. test_accelerator_policy's cases
are split between this file and test_torch_brute_refusals.py so no file
holds more than ten cases.
"""
import pytest

from test_torch_brute import POLICY_CASES, check_policy


@pytest.mark.parametrize("accel, body, result", POLICY_CASES)
def test_accelerator_policy(accel, body, result):
    check_policy(accel, body, result)
