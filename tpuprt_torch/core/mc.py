"""Monte Carlo warps, the MIS heuristic and the phase functions (port of
tpuprt/core/mc.py, the parts the port uses)."""
from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric map (core/mc.cpp:89-131), branchless."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    abs_sx, abs_sy = torch.abs(sx), torch.abs(sy)
    cond = abs_sx > abs_sy
    r = torch.where(cond, abs_sx, abs_sy)

    def safe(n, d):
        return n / torch.where(torch.abs(d) < 1e-20,
                               torch.full_like(d, 1e-20), d)

    a = torch.where(cond, safe(sy, sx), safe(sx, sy))
    theta = torch.where(cond,
                        torch.where(sx >= 0, a, 4.0 + a),
                        torch.where(sy >= 0, 2.0 - a, 6.0 - a))
    theta = theta * (math.pi / 4.0)
    dx = torch.where(zero, torch.zeros_like(r), r * torch.cos(theta))
    dy = torch.where(zero, torch.zeros_like(r), r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2):
    """core/mc.h:38-44 — concentric disk + project up."""
    x, y = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=1e-12))
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_sphere(u1, u2):
    """core/mc.cpp:68-77."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sphere_pdf():
    """core/mc.cpp:78-80: 1 / (4 pi)."""
    return 1.0 / (4.0 * math.pi)


def uniform_sample_cone(u1, u2, costhetamax):
    """core/mc.cpp:140-149 -- a direction uniform in the cone of half-angle
    acos(costhetamax) about +z."""
    costheta = (1.0 - u1) * 1.0 + u1 * costhetamax      # Lerp(u1, 1, max)
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, min=1e-12))
    phi = u2 * 2.0 * math.pi
    return torch.stack([torch.cos(phi) * sintheta, torch.sin(phi) * sintheta,
                        costheta], dim=-1)


def uniform_sample_cone_frame(u1, u2, costhetamax, x, y, z):
    """core/mc.cpp:150-158 -- a direction uniform in the cone of half-angle
    acos(costhetamax) about z, in the frame (x, y, z)."""
    costheta = (1.0 - u1) * 1.0 + u1 * costhetamax      # Lerp(u1, 1, max)
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, min=1e-12))
    phi = u2 * 2.0 * math.pi
    return (torch.cos(phi) * sintheta)[..., None] * x + \
        (torch.sin(phi) * sintheta)[..., None] * y + costheta[..., None] * z


def uniform_cone_pdf(costhetamax):
    """core/mc.cpp:159-161."""
    return 1.0 / (2.0 * math.pi * torch.clamp(1.0 - costhetamax, min=1e-8))


def hg_pdf(costheta, g):
    """The Henyey-Greenstein phase function, which is its own pdf
    (core/volume.cpp PhaseHG; tpuprt/core/mc.py:127-131)."""
    denom = 1.0 + g * g + 2.0 * g * costheta
    return (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


_INV_4PI = 1.0 / (4.0 * math.pi)


def phase_isotropic(costheta):
    """PhaseIsotropic (core/volume.cpp:28-30)."""
    return torch.full_like(torch.as_tensor(costheta, dtype=torch.float32),
                           _INV_4PI)


def phase_rayleigh(costheta):
    """PhaseRayleigh (core/volume.cpp:31-34)."""
    return 3.0 / (16.0 * math.pi) * (1.0 + costheta * costheta)


def phase_mie_hazy(costheta):
    """PhaseMieHazy (core/volume.cpp:35-38)."""
    return (0.5 + 4.5 * torch.pow(
        torch.clamp(0.5 * (1.0 + costheta), min=0.0), 8.0)) * _INV_4PI


def phase_mie_murky(costheta):
    """PhaseMieMurky (core/volume.cpp:39-42)."""
    return (0.5 + 16.5 * torch.pow(
        torch.clamp(0.5 * (1.0 + costheta), min=0.0), 32.0)) * _INV_4PI


def phase_schlick(costheta, g):
    """PhaseSchlick (core/volume.cpp:49-56): Henyey-Greenstein's
    approximation with k = 1.55 g - 0.55 g^3."""
    k = 1.55 * g - 0.55 * g * g * g
    kcos = k * costheta
    return _INV_4PI * (1.0 - k * k) / torch.clamp(
        (1.0 - kcos) * (1.0 - kcos), min=1e-12)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """core/mc.h:55-59 — beta=2."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def distribution1d_build(func):
    """Distribution1D (core/mc.cpp:31-53; tpuprt/core/mc.py:164-175) over
    nonnegative weights f32[..., N]: (func, cdf f32[..., N + 1], func_int),
    the cdf the f32 cumulative sum over N, normalized by its last entry
    (left unnormalized where that is 0)."""
    n = func.shape[-1]
    cdf = torch.cat([torch.zeros(func.shape[:-1] + (1,), dtype=func.dtype,
                                 device=func.device),
                     torch.cumsum(func, dim=-1) / n], dim=-1)
    func_int = cdf[..., -1]
    safe_int = torch.where(func_int > 0, func_int, 1.0)
    return func, cdf / safe_int[..., None], func_int


def distribution1d_sample_discrete(func, cdf, func_int, u):
    """Index i with probability func[i] / sum (tpuprt/core/mc.py:191-196):
    the last cdf entry <= u, clamped to [0, N); returns (i i64, pmf)."""
    n = func.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    pmf = func[idx] / torch.clamp(func_int * n, min=1e-20)
    return idx, pmf
