"""test_accelerator_policy's cases on area lights and objects: a mesh
emitter parses, an area light on a cone or of another name parses as
tpuprt's parser reads it, an emissive object never instanced leaves the
main aggregate empty and parses. Split from test_torch_brute_policy.py's
cases so no file holds more than ten cases.
"""
import pytest

from test_torch_brute import AREA_CASES, check_policy


@pytest.mark.parametrize("accel, body, result", AREA_CASES)
def test_accelerator_policy(accel, body, result):
    check_policy(accel, body, result)
