"""The port's gradients against central finite differences per case
(camera, texel, BVH, brute force, instances); split from
test_torch_grad.py so no file holds more than ten cases.
"""
import pytest

from test_torch_grad import (brute_case, bvh_case, camera_case, instance_case,
                             texel_case)


@pytest.mark.parametrize("case", ["camera", "texel", "bvh", "brute",
                                  "instance"])
def test_grad_matches_fd(case, tmp_path):
    g, fd, tol = {"camera": camera_case, "texel": lambda: texel_case(
        tmp_path), "bvh": bvh_case, "brute": brute_case,
        "instance": instance_case}[case]()
    assert abs(g - fd) < tol, (g, fd)
