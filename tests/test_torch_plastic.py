"""The port's plastic material and microfacet lobe held against tpuprt's
BSDF on the CPU.

The material table is config2's (a matte and a plastic material), its
texture slots given random values per lane; each lane gets a random
shading frame, random directions and random sample streams. Then f, pdf
and sample_f, and the distribution and Fresnel terms on their own, for
both distributions and all three Fresnel kinds.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpuprt.bsdf import bsdf as jB
from tpuprt.materials import factory as jF
from tpuprt.scene.parser import load_scene_string as jax_load
from tpuprt_torch.bsdf import bsdf as tB
from tpuprt_torch.materials import factory as tF
from tpuprt_torch.scene.parser import load_scene_string

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from make_scenes import config2  # noqa: E402

N = 4096


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def batches():
    """The same BSDF wavefront in both packages: (jax batch, port batch,
    wo, wi world directions, u f32[3,N])."""
    text = config2().replace('Accelerator "grid"', 'Accelerator "none"')
    jm = jax_load(text)[0].materials
    tscene = load_scene_string(text)[0]
    tm = tscene.materials
    assert tm.lobe_kinds == (tB.BX_LAMBERTIAN, tB.BX_ORENNAYAR,
                             tB.BX_MICROFACET)
    assert tm.dist_kinds == (tB.DIST_BLINN,)
    rng = np.random.default_rng(2)
    ntex = tscene.textures.fparams.shape[0]
    # Slot values in [0.01, 1): a plastic's roughness then spans Blinn
    # exponents 1 to 100. (At the cap of 1e4 a 1-ulp difference in the
    # half-vector's cosine moves D by 6e-4 relative.)
    tex = rng.uniform(0.01, 1.0, (ntex, N, 3)).astype(np.float32)
    mat = rng.integers(0, tm.count, N).astype(np.int32)
    ng = unit(rng, N)
    nn = np.where(rng.uniform(size=(N, 1)) < 0.8, ng, unit(rng, N))
    dpdu = unit(rng, N)
    wo, wi = unit(rng, N), unit(rng, N)
    # No grazing wo: a mirrored wi's half-vector is nn, and a cosine near
    # 0 there divides the rounding of the dot products into the pdf.
    graze = np.abs((wo * nn).sum(1, keepdims=True)) < 0.05
    wo = np.where(graze, wo + 0.2 * nn, wo)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    # A third of wi mirror wo about nn, where the glossy lobe peaks.
    m = np.arange(N) % 3 == 0
    wi[m] = (-wo + 2 * (wo * nn).sum(1, keepdims=True) * nn)[m]
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)

    jl = jF.make_lobes(jm, jnp.asarray(mat), jnp.asarray(tex))
    jb = jB.BsdfBatch(*jB.make_frame(*map(jnp.asarray, (nn, dpdu, ng))),
                      lobes=jl)
    tl = tF.make_lobes(tm, torch.from_numpy(mat), torch.from_numpy(tex))
    tb = tB.BsdfBatch(*tB.make_frame(*map(torch.from_numpy,
                                           (nn, dpdu, ng))), lobes=tl)
    return jb, tb, wo, wi, u


def close(t, j, what, rtol=2e-4, atol=1e-6):
    """Float rounding of eager torch against XLA (pow, sqrt and the dot
    products' order), amplified by pow's exponent: rtol 2e-4, atol 1e-6."""
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


def test_lobes_match_tpuprt(batches):
    jb, tb, *_ = batches
    jl, tl = jb.lobes, tb.lobes
    for k in ("kind", "flags", "aux0", "aux1"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)
    for k in ("R", "eta", "k"):
        close(getattr(tl, k), getattr(jl, k), k)
    close(tl.p, np.asarray(jl.p)[..., :2], "p")
    assert (np.asarray(jl.kind) == jB.BX_MICROFACET).sum() > N // 4


@pytest.mark.parametrize("mask", [jB.ALL, jB.ALL & ~jB.SPECULAR,
                                  jB.REFLECTION | jB.GLOSSY])
def test_f_pdf_sample_match_tpuprt(batches, mask):
    jb, tb, wo, wi, u = batches
    jf = jB.f(jb, jnp.asarray(wo), jnp.asarray(wi), mask)
    close(tB.f(tb, torch.from_numpy(wo), torch.from_numpy(wi), mask), jf,
          "f")
    assert (np.asarray(jf) > 0).any(1).mean() > 0.1
    jp = jB.pdf(jb, jnp.asarray(wo), jnp.asarray(wi), mask)
    close(tB.pdf(tb, torch.from_numpy(wo), torch.from_numpy(wi), mask), jp,
          "pdf")
    js = jB.sample_f(jb, jnp.asarray(wo), *map(jnp.asarray, u), mask)
    ts = tB.sample_f(tb, torch.from_numpy(wo), *map(torch.from_numpy, u),
                     mask)
    for k in ("valid", "flags", "specular"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    ok = np.asarray(js["valid"])
    assert ok.mean() > 0.15
    close(ts["wi"], js["wi"], "wi", atol=1e-5)
    close(ts["f"], js["f"], "sample f", rtol=1e-3, atol=1e-5)
    close(ts["pdf"], js["pdf"], "sample pdf", rtol=1e-3, atol=1e-5)


def test_distributions_and_fresnel_match_tpuprt():
    """The Blinn and anisotropic distributions (D, pdf, half-vector
    sampling) and the dielectric, conductor and no-op Fresnel terms, lane
    by lane over a mix of kinds (reflection.cpp:31-96, 246-332)."""
    rng = np.random.default_rng(4)
    n = 2048
    aux1 = rng.integers(0, 2, n).astype(np.int32)
    aux0 = rng.integers(0, 3, n).astype(np.int32)
    p = (1.0 / rng.uniform(0.01, 1.0, (n, 2))).astype(np.float32)  # <= 100
    wo, wi = unit(rng, n), unit(rng, n)
    wo[:, 2] = np.abs(wo[:, 2])
    wi[:, 2] = np.abs(wi[:, 2])
    wh = unit(rng, n)
    u1, u2 = rng.uniform(0, 1, (2, n)).astype(np.float32)
    eta = rng.uniform(0.2, 3.0, (n, 3)).astype(np.float32)
    k = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    cosi = rng.uniform(-1, 1, n).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    p4 = np.concatenate([p, np.zeros_like(p)], 1)
    close(tB._dist_d(t(aux1), t(p), t(wh)), jB._dist_d(j(aux1), j(p4), j(wh)),
          "D")
    close(tB._dist_pdf(t(aux1), t(p), t(wo), t(wi)),
          jB._dist_pdf(j(aux1), j(p4), j(wo), j(wi)), "pdf")
    close(tB._dist_sample_wh(t(aux1), t(p), t(wo), t(u1), t(u2)),
          jB._dist_sample_wh(j(aux1), j(p4), j(wo), j(u1), j(u2)), "wh",
          atol=1e-5)
    close(tB._fresnel_eval(t(aux0), t(eta), t(k), t(cosi)),
          jB._fresnel_eval(j(aux0), j(eta), j(k), j(cosi)), "F")
