"""Silhouette (visibility-discontinuity) gradients by edge sampling (port of
tpuprt/diff/silhouette.py).

render_loss_fn (parallel/shard.py) differentiates shading but holds
visibility constant: an occluder's silhouette moving across a bright
background, or its shadow across a lit floor, changes which pixels see
what, a boundary integral the interior estimator cannot see. Three
estimators add it (Li et al. 2018's edge sampling):

1. Primary visibility: mesh silhouette edges (facing disagreement or mesh
   boundary w.r.t. the camera) and full spheres' rims, projected into the
   image. For Loss = Integral g(I(x), x) dx,

     dLoss/dtheta  >=  Sum_curves Integral_0^1 [g(L-) - g(L+)]
                           (n_perp . d xy_c/d theta) |d xy_c/d u| du,

   with L-, L+ the radiance a half pixel to either side of the curve point
   xy_c(u): an occluded curve point sees the occluder on both sides, and
   its jump vanishes.
2. Shadow boundaries of delta lights (point, spot, projection,
   goniometric, distant): an occluder's silhouette edge (w.r.t. the light)
   projected from the light onto the receiver's detached tangent plane,
   then into the image like a primary curve.
3. Shadow boundaries of area lights on planar triangle meshes: the jump
   lives on the light's plane, where a receiver's NEE integrand
   f Le G V jumps across the edge's projection from the receiver; (pixel,
   edge, u) are sampled jointly and the jump read with two real shadow
   rays either side.

Each term is a surrogate sum_k c_k (n_k . xy_k(theta)) with c_k and n_k
detached, so autograd of it is the boundary term; the loss composes as
interior + surrogate - surrogate.detach(): the value is unchanged and the
gradient augmented. Edge samples are stratified: every edge gets
ceil(M/E) samples with u stratified along it. The random draws are
jax.random's threefry, bit for bit (core/jrandom.py), so a sample here is
tpuprt's sample. Over several ranks, each may take a contiguous block of
the samples (part=(rank, size)); the blocks' shares sum to the whole term.

The tangent d xy/du is a forward-mode derivative (torch.func.jvp) on
detached inputs; the differentiable positions xy(theta) come from one plain
call on the live lanes only, so a masked lane (a miss, a receiver seen
edge-on, a point behind the camera) never enters the backward pass, where
0 * NaN would poison the sum (tpuprt selects both factors out instead).
Rays for the side radiances and the receivers go through the scene's walk
(the kernels on the card) with no gradient, as tpuprt's sg(scene).

Two faults of the reference are corrected here:
- render_loss_with_silhouette weights the boundary densities by spp /
  n_total, the global sample count, where tpuprt takes the per-shard
  px.shape[0] (silhouette.py:605-609), which makes a D-device boundary
  gradient D times too large;
- area_shadow_surrogate tests one-sided emission against the emitting
  normal, the geometric one times the emitter's flip_normal, as the
  lights' NEE does (lights/lights.py); tpuprt ignores flip_normal there
  (silhouette.py:525).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import render as R
from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..cameras import cameras as cam_mod
from ..core import jrandom
from ..core import vecmath as vm
from ..integrators import common
from ..parallel.shard import render_loss_fn
from ..samplers import samplers as smp
from ..scene import data as D
from ..scene.data import SceneData

TERMS = ("primary", "shadow", "rim", "area")
# Live edge samples by term since the last reset: the lanes whose
# positions enter the surrogate (a term with none adds no gradient).
live_lanes = dict.fromkeys(TERMS, 0)


def mesh_edges(idx: np.ndarray):
    """Static edge topology of a triangle mesh: (edges i32[E,2] vertex ids,
    sorted, adj i32[E,2] the first two triangles holding each edge in
    triangle order, -1 for boundary). Vectorised; tpuprt's dict loop gives
    the same arrays."""
    idx = np.asarray(idx).astype(np.int64).reshape(-1, 3)
    if len(idx) == 0:
        return np.zeros((0, 2), np.int32), np.zeros((0, 2), np.int32)
    a, b = idx.reshape(-1), idx[:, [1, 2, 0]].reshape(-1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    K = int(hi.max()) + 1
    keys, inv = np.unique(lo * K + hi, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")     # each edge's holders in order
    count = np.bincount(inv, minlength=len(keys))
    start = np.cumsum(count) - count
    tri = (order // 3).astype(np.int32)
    adj = np.full((len(keys), 2), -1, np.int32)
    adj[:, 0] = tri[start]
    two = count > 1
    adj[two, 1] = tri[start[two] + 1]
    edges = np.stack([keys // K, keys % K], 1).astype(np.int32)
    return edges, adj


def _zero(scene):
    return torch.zeros((), dtype=torch.float32,
                       device=scene.triangles.verts.device)


def _project(cam, p):
    """World points -> continuous raster (x, y) and a valid mask (w > 0):
    cam2raster = inv(raster2cam) . world2cam with the homogeneous divide."""
    C = torch.linalg.inv(cam.raster2cam) @ cam.world2cam
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    h = ph @ C.T
    w = h[..., 3]
    ok = w > 1e-6
    wsafe = torch.where(ok, w, 1.0)
    return h[..., 0] / wsafe, h[..., 1] / wsafe, ok


def _lens_centre(x):
    """(lens_u, lens_v, time) of tpuprt's boundary rays: (0.5, 0.5, 0)."""
    half = torch.full_like(x, 0.5)
    return half, half, torch.zeros_like(x)


@torch.no_grad()
def _radiance_at(scene, opts, x, y):
    """Detached radiance through raster points (x, y) by the configured
    integrator's scan Li, the lens sample at the lens's centre and the
    time 0 (tpuprt/diff/silhouette.py:111-116)."""
    o, d, mint, maxt, _ = cam_mod.generate_rays(
        scene.camera, x, y, *_lens_centre(x), opts.xres, opts.yres)
    px = torch.clamp(x.to(torch.int32), 0, opts.xres - 1)
    py = torch.clamp(y.to(torch.int32), 0, opts.yres - 1)
    return R.li(scene, opts, None, o, d, mint, maxt, px, py,
                torch.zeros_like(px))[0]


def _block(n: int, part):
    """The lanes of n that rank part[0] of part[1] takes: contiguous
    blocks, so that the ranks' shares sum to the whole term."""
    rank, size = part
    per = -(-n // size)
    return slice(min(rank * per, n), min((rank + 1) * per, n))


def _edge_samples(E: int, n_samples: int, key):
    """Stratified (edge, u) sampling: every edge gets reps = ceil(n/E)
    samples with u stratified over reps bins; the weight E/M per sample
    keeps the estimate of sum_edges Integral_0^1 unbiased."""
    reps = max(1, -(-n_samples // E))
    M = reps * E
    ei = torch.arange(E, device=key.device).repeat(reps)
    bins = torch.arange(reps, dtype=torch.float32,
                        device=key.device).repeat_interleave(E)
    u = (bins + jrandom.uniform(key, (M,))) / reps
    return ei, u, M


def _jvp(fn, u, lanes):
    """(fn's output, its derivative in u along ones, fn's aux) of fn(u,
    *lanes) -> (output, aux), on detached lanes and without autograd."""
    with torch.no_grad():
        return torch.func.jvp(lambda uu: fn(uu, *lanes), (u,),
                              (torch.ones_like(u),), has_aux=True)


def _live_sum(term, c, normal, fn, u, lanes, live):
    """sum_k c_k (normal_k . fn(u_k, lanes_k)[0]) over the live lanes, with
    fn's positions differentiable in the scene (and in lanes); counts them
    in live_lanes[term]."""
    k = torch.nonzero(live).squeeze(1)
    live_lanes[term] += k.numel()
    pos = fn(u[k], *(x[k] for x in lanes))[0]
    return torch.sum(c[k] * torch.sum(normal[k] * pos, dim=-1))


def _image_jump_surrogate(scene, opts, jump_fn, xy_fn, u, lanes, mask,
                          weight: float, eps_pix: float, term: str):
    """The image-space estimators' common tail: xy_fn(u, *lanes) -> (xy
    f32[M,2] differentiable raster positions, ok) maps the curve parameter
    to the image; returns sum_k c_k (n_perp_k . xy_k(theta)) with c_k =
    jump * |dxy/du| * weight."""
    if u.shape[0] == 0:
        return _zero(scene)
    det = [x.detach() for x in lanes]
    xy, dxy_du, ok = _jvp(xy_fn, u, det)
    arclen = torch.linalg.vector_norm(dxy_du, dim=-1)
    tgt = dxy_du / torch.clamp(arclen, min=1e-12)[:, None]
    n_perp = torch.stack([tgt[:, 1], -tgt[:, 0]], -1)   # 90-degree turn

    x_m = xy[:, 0] - eps_pix * n_perp[:, 0]
    y_m = xy[:, 1] - eps_pix * n_perp[:, 1]
    x_p = xy[:, 0] + eps_pix * n_perp[:, 0]
    y_p = xy[:, 1] + eps_pix * n_perp[:, 1]
    L_m = _radiance_at(scene, opts, x_m, y_m)
    L_p = _radiance_at(scene, opts, x_p, y_p)

    px = torch.clamp(xy[:, 0].to(torch.int32), 0, opts.xres - 1)
    py = torch.clamp(xy[:, 1].to(torch.int32), 0, opts.yres - 1)
    inside = (xy[:, 0] >= 0) & (xy[:, 0] < opts.xres) & \
        (xy[:, 1] >= 0) & (xy[:, 1] < opts.yres)
    live = mask & ok & inside & torch.isfinite(arclen)
    with torch.no_grad():
        c = jump_fn(L_m, L_p, px, py) * arclen
        c = torch.where(live, c, 0.0) * weight
    return _live_sum(term, c, n_perp, xy_fn, u, lanes, live)


def _tri_facing(verts, idxs, from_pt):
    """Detached per-triangle facing w.r.t. a viewpoint ([3] or [M,3])."""
    p0, p1, p2 = (verts[idxs[:, k]] for k in range(3))
    fn = vm.cross(p1 - p0, p2 - p0)
    cen = (p0 + p1 + p2) / 3.0
    return vm.dot(fn, from_pt - cen) > 0.0


def _silhouette_mask(verts, idxs, adj, viewpoint=None, direction=None):
    """bool[E]: facing disagreement w.r.t. a viewpoint (or a directional
    light's direction), or a mesh-boundary edge."""
    p0, p1, p2 = (verts[idxs[:, k]] for k in range(3))
    fn = vm.cross(p1 - p0, p2 - p0)
    if direction is not None:
        facing = vm.dot(fn, -direction.expand_as(fn)) > 0.0
    else:
        cen = (p0 + p1 + p2) / 3.0
        facing = vm.dot(fn, viewpoint[None, :] - cen) > 0.0
    f0 = facing[torch.clamp(adj[:, 0], min=0)]
    f1 = facing[torch.clamp(adj[:, 1], min=0)]
    return (adj[:, 1] < 0) | (f0 != f1)


def _mesh_topology(scene, topology=None):
    """(edges i64[E,2], adj i64[E,2], E) on the scene's device, from
    `topology` (mesh_edges' pair) or from the triangle table."""
    tri = scene.triangles
    edges_np, adj_np = topology if topology is not None else \
        mesh_edges(tri.idx.cpu().numpy())
    dev = tri.verts.device
    return (torch.as_tensor(np.asarray(edges_np), device=dev).long(),
            torch.as_tensor(np.asarray(adj_np), device=dev).long(),
            len(edges_np))


def silhouette_surrogate(scene: SceneData, opts: R.RenderOptions, jump_fn,
                         n_samples: int = 1024, seed: int = 0,
                         eps_pix: float = 0.5, topology=None,
                         part=(0, 1)):
    """Surrogate scalar whose gradient w.r.t. the scene is the primary-
    visibility boundary term of Integral g(I(x,y), x,y) dx dy (unit-area
    pixels) for triangle-mesh silhouettes. jump_fn(L_m, L_p, px, py) ->
    f32[M] gives the loss-density jump g(L_m) - g(L_p) at those pixels.
    part=(rank, size): only that rank's block of the edge samples, its
    share of the term (the surrogates all take it)."""
    tri = scene.triangles
    if tri.count == 0:
        return _zero(scene)
    edges, adj, E = _mesh_topology(scene, topology)
    verts = tri.verts                                  # theta flows here
    idxs = tri.idx.long()
    cam = scene.camera
    sil = _silhouette_mask(verts.detach(), idxs, adj,
                           viewpoint=cam.cam2world[:3, 3].detach())
    ei, u, M = _edge_samples(E, n_samples, jrandom.PRNGKey(
        seed, verts.device))
    b = _block(M, part)
    ei, u = ei[b], u[b]
    v0 = verts[edges[ei, 0]]
    v1 = verts[edges[ei, 1]]

    def xy_of(uu, v0, v1):
        x, y, ok = _project(cam, v0 + uu[:, None] * (v1 - v0))
        return torch.stack([x, y], -1), ok

    return _image_jump_surrogate(scene, opts, jump_fn, xy_of, u, (v0, v1),
                                 sil[ei], E / M, eps_pix, "primary")


def sphere_rim_surrogate(scene: SceneData, opts: R.RenderOptions, jump_fn,
                         n_samples: int = 256, seed: int = 0,
                         eps_pix: float = 0.5, part=(0, 1)):
    """The primary-visibility rim term of full spheres (kind sphere,
    phimax 360 and the whole z range, by QuadricTable.static_rows): the
    rim circle (p - c).(o - p) = 0 parametrized by phi, projected to the
    image; differentiable in the sphere's o2w translation and its radius.
    The phi frame's drift is tangential and projects out through n_perp.
    Partial quadrics are not covered."""
    q = scene.quadrics
    if q is None or q.count == 0:
        return _zero(scene)
    sphere_ids = [i for i, (k, phi_full, z_full) in enumerate(q.static_rows)
                  if k == D.QUADRIC_SPHERE and phi_full and z_full]
    total = _zero(scene)
    if not sphere_ids:
        return total
    cam = scene.camera
    cam_pos = cam.cam2world[:3, 3]
    key = jrandom.PRNGKey(seed ^ 0x5F3E, total.device)
    Mn = int(n_samples)
    for qi in sphere_ids:
        c = q.o2w[qi, :3, 3]                           # theta flows here
        Rr = q.params[qi, 0]                           # and here
        to_cam = cam_pos - c
        dist = torch.clamp(vm.length(to_cam), min=1e-9)
        uhat = to_cam / dist
        outside = dist > Rr * (1.0 + 1e-6)             # no rim from inside
        sin2 = torch.clamp(1.0 - (Rr / dist) ** 2, 0.0, 1.0)
        _, t1, t2 = vm.coordinate_system(uhat)
        key, ku = jrandom.split(key)
        phi = ((torch.arange(Mn, dtype=torch.float32, device=key.device) +
                jrandom.uniform(ku, (Mn,))) * (2.0 * np.pi / Mn))[
                    _block(Mn, part)]

        def xy_of(ph, c=c, Rr=Rr, uhat=uhat, t1=t1, t2=t2, sin2=sin2,
                  dist=dist):
            p = (c[None, :] + (Rr * Rr / dist) * uhat[None, :] +
                 (Rr * torch.sqrt(sin2)) *
                 (torch.cos(ph)[:, None] * t1[None, :] +
                  torch.sin(ph)[:, None] * t2[None, :]))
            x, y, ok = _project(cam, p)
            return torch.stack([x, y], -1), ok

        # xy_of is parametrized by phi itself: |dxy/dphi| takes the
        # stratified grid's (2 pi / Mn) quadrature weight.
        total = total + _image_jump_surrogate(
            scene, opts, jump_fn, xy_of, phi, (),
            outside.expand(phi.shape[0]), 2.0 * np.pi / Mn, eps_pix, "rim")
    return total


def shadow_silhouette_surrogate(scene: SceneData, opts: R.RenderOptions,
                                jump_fn, n_samples: int = 1024,
                                seed: int = 0, eps_pix: float = 0.5,
                                topology=None, part=(0, 1)):
    """The shadow-boundary term of delta lights (point, spot, projection,
    goniometric, distant): occluder silhouette edges (w.r.t. the light)
    projected onto the first receiver, then into the image; the jump read
    from the rendered image like the primary term's. The receiver is
    locally planar (its detached tangent plane at the cast hit)."""
    tri = scene.triangles
    lk = scene.lights.kinds_list
    delta_ids = [i for i, k in enumerate(lk)
                 if k in (D.LIGHT_POINT, D.LIGHT_SPOT, D.LIGHT_PROJECTION,
                          D.LIGHT_GONIOMETRIC, D.LIGHT_DISTANT)]
    total = _zero(scene)
    if tri.count == 0 or not delta_ids:
        return total
    edges, adj, E = _mesh_topology(scene, topology)
    verts = tri.verts
    idxs = tri.idx.long()
    cam = scene.camera
    for li, lid in enumerate(delta_ids):
        distant = lk[lid] == D.LIGHT_DISTANT
        lpos = scene.lights.l2w[lid, :3, 3]            # theta flows here
        ldir = -scene.lights.params[lid, 0:3]          # shadow direction
        if distant:
            sil = _silhouette_mask(verts.detach(), idxs, adj,
                                   direction=ldir.detach())
        else:
            sil = _silhouette_mask(verts.detach(), idxs, adj,
                                   viewpoint=lpos.detach())
        ei, u, M = _edge_samples(E, n_samples, jrandom.PRNGKey(
            seed + 7919 * li, verts.device))
        b = _block(M, part)
        if b.start == b.stop:
            continue
        ei, u = ei[b], u[b]
        v0 = verts[edges[ei, 0]]
        v1 = verts[edges[ei, 1]]
        with torch.no_grad():
            e_s = v0 + u[:, None] * (v1 - v0)
            d_s = ldir.expand_as(e_s) if distant else e_s - lpos[None, :]
            dn = d_s / torch.clamp(torch.linalg.vector_norm(
                d_s, dim=-1, keepdim=True), min=1e-12)
            # The detached receiver, cast from just beyond the edge point.
            o_r = e_s + 1e-3 * dn
            t, pid, hitm = isect.intersect_ids(
                scene, o_r, dn, torch.full_like(u, vm.RAY_EPSILON),
                torch.full_like(u, 1e30))
            dg = isect.hit_geometry(scene, torch.clamp(pid, min=0), o_r, dn,
                                    t)
            p_r, n_r = dg["p"], dg["nn"]
            # A receiver beyond the edge, not seen edge-on.
            mask = sil[ei] & hitm & (torch.abs(vm.dot(n_r, dn)) > 1e-4)

        def xy_of(uu, v0, v1, n_r, p_r, lpos=lpos, ldir=ldir,
                  distant=distant):
            e = v0 + uu[:, None] * (v1 - v0)           # differentiable
            if distant:
                d = ldir.expand_as(e)
                denom = vm.dot(n_r, d)
                s = vm.dot(n_r, p_r - e) / torch.where(
                    torch.abs(denom) < 1e-9, 1e-9, denom)
                r = e + s[:, None] * d
            else:
                d = e - lpos[None, :]
                denom = vm.dot(n_r, d)
                s = vm.dot(n_r, p_r - lpos[None, :]) / torch.where(
                    torch.abs(denom) < 1e-9, 1e-9, denom)
                r = lpos[None, :] + s[:, None] * d
            x, y, ok = _project(cam, r)
            return torch.stack([x, y], -1), ok

        total = total + _image_jump_surrogate(
            scene, opts, jump_fn, xy_of, u, (v0, v1, n_r, p_r), mask,
            E / M, eps_pix, "shadow")
    return total


def _point_in_light_tris(scene, lid: int, pts):
    """bool[M]: pts lie inside one of area light lid's emitting triangles
    (coplanar: callers project onto the plane)."""
    lights, tri = scene.lights, scene.triangles
    first = lights.area_first[lid]
    count = lights.area_count[lid]
    inside = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for k in range(max(1, lights.max_area_count)):
        i3 = tri.idx[torch.clamp(first + k, 0, tri.count - 1)].long()
        a, b, c = (tri.verts[i3[j]] for j in range(3))
        v0 = b - a
        v1 = c - a
        v2 = pts - a[None, :]
        d00 = vm.dot(v0, v0)
        d01 = vm.dot(v0, v1)
        d11 = vm.dot(v1, v1)
        d20 = vm.dot(v2, v0.expand_as(v2))
        d21 = vm.dot(v2, v1.expand_as(v2))
        den = torch.clamp(d00 * d11 - d01 * d01, min=1e-12)
        bv = (d11 * d20 - d01 * d21) / den
        bw = (d00 * d21 - d01 * d20) / den
        ok = (bv >= -1e-4) & (bw >= -1e-4) & (bv + bw <= 1.0 + 1e-4)
        inside = inside | (ok & (k < count))
    return inside


def _edge_tri_facing(verts, idxs, tid, from_pts):
    """Detached facing of triangles tid[M] w.r.t. per-sample points."""
    i3 = idxs[tid]
    p0, p1, p2 = (verts[i3[:, k]] for k in range(3))
    fn = vm.cross(p1 - p0, p2 - p0)
    cen = (p0 + p1 + p2) / 3.0
    return vm.dot(fn, from_pts - cen) > 0.0


def area_shadow_surrogate(scene: SceneData, opts: R.RenderOptions,
                          adjoint_fn, n_samples: int = 2048,
                          seed: int = 0, topology=None,
                          delta_frac: float = 1e-3, part=(0, 1)):
    """The shadow-boundary term of area lights on planar triangle meshes:
    (pixel, edge, u) sampled jointly, the edge point projected from the
    receiver onto the light's plane, the NEE integrand's jump read with
    two real shadow rays either side of the curve. adjoint_fn(px, py, I)
    -> f32[M,3] gives dg/dI of the loss density at those pixels given the
    detached rendered radiance I."""
    tri = scene.triangles
    lk = scene.lights.kinds_list
    area_ids = [i for i, k in enumerate(lk) if k == D.LIGHT_AREA]
    total = _zero(scene)
    if tri.count == 0 or not area_ids:
        return total
    edges, adj, E = _mesh_topology(scene, topology)
    verts = tri.verts
    idxs = tri.idx.long()
    cam = scene.camera
    W, H = opts.xres, opts.yres
    dev = verts.device
    for li, lid in enumerate(area_ids):
        # Quadric emitters have no plane.
        if int(scene.lights.area_geom_kind[lid]) != D.AREA_GEOM_TRIS:
            continue
        k1, k2, k3, _ = jrandom.split(jrandom.PRNGKey(seed + 104729 * li,
                                                      dev), 4)
        ei, u, M = _edge_samples(E, n_samples, k1)
        b = _block(M, part)
        if b.start == b.stop:
            continue
        ei, u = ei[b], u[b]
        v0 = verts[edges[ei, 0]]
        v1 = verts[edges[ei, 1]]
        with torch.no_grad():
            # Pixel and receiver samples.
            x = (jrandom.uniform(k2, (M,)) * W)[b]
            y = (jrandom.uniform(k3, (M,)) * H)[b]
            o, d, mint, maxt, _ = cam_mod.generate_rays(
                cam, x, y, *_lens_centre(x), W, H)
            t, pid, hitm = isect.intersect_ids(scene, o, d, mint, maxt)
            dgp = isect.hit_geometry(scene, torch.clamp(pid, min=0), o, d,
                                     t)
            p = dgp["p"]
            wo = -d
            bsdf = common.make_bsdf_at(scene, dgp)
            # The light's plane, from its first triangle; it emits to the
            # side of n_L times that triangle's flip_normal.
            first = torch.clamp(scene.lights.area_first[lid], 0,
                                tri.count - 1)
            i3 = tri.idx[first].long()
            la, lb, lc = (verts[i3[j]] for j in range(3))
            n_L = vm.normalize(vm.cross(lb - la, lc - la))
            n_emit = n_L * tri.flip_normal[first]
            t1 = vm.normalize(lb - la)
            t2 = vm.cross(n_L, t1)
            diam = torch.clamp(torch.maximum(vm.length(lb - la),
                                             vm.length(lc - la)), min=1e-6)
            delta = diam * delta_frac
            # Silhouette edges w.r.t. each receiver point.
            a0, a1 = adj[ei, 0], adj[ei, 1]
            vd = verts.detach()
            f0 = _edge_tri_facing(vd, idxs, torch.clamp(a0, min=0), p)
            f1 = _edge_tri_facing(vd, idxs, torch.clamp(a1, min=0), p)
            sil = (a1 < 0) | (f0 != f1)

        def l2d_of(uu, v0, v1, p, n_L=n_L, la=la, t1=t1, t2=t2):
            e = v0 + uu[:, None] * (v1 - v0)           # differentiable
            dvec = e - p
            denom = vm.dot(n_L, dvec)
            s = vm.dot(n_L, la[None, :] - p) / torch.where(
                torch.abs(denom) < 1e-9, 1e-9, denom)
            rel = p + s[:, None] * dvec - la[None, :]
            return torch.stack([vm.dot(rel, t1.expand_as(rel)),
                                vm.dot(rel, t2.expand_as(rel))], -1), s

        lanes = (v0, v1, p)
        l2d, dl_du, s_e = _jvp(l2d_of, u, [x.detach() for x in lanes])
        arclen = torch.linalg.vector_norm(dl_du, dim=-1)
        tangent = dl_du / torch.clamp(arclen, min=1e-12)[:, None]
        n_A = torch.stack([tangent[:, 1], -tangent[:, 0]], -1)

        @torch.no_grad()
        def integrand(l2, lid=lid, la=la, t1=t1, t2=t2, n_L=n_L,
                      n_emit=n_emit, p=p, bsdf=bsdf, wo=wo, dgp=dgp):
            """The NEE integrand f Le G V toward light-plane points l2."""
            lw = la[None, :] + l2[:, 0:1] * t1[None, :] \
                + l2[:, 1:2] * t2[None, :]
            wi_un = lw - p
            d2 = torch.clamp(vm.length_sq(wi_un), min=1e-12)
            wi = wi_un * torch.rsqrt(d2)[:, None]
            on_light = _point_in_light_tris(scene, lid, lw)
            cos_l = torch.abs(vm.dot(n_L, -wi))
            emits = vm.dot(n_emit.expand_as(wi), -wi) > 0
            Le = scene.lights.spectrum[lid]
            fr = B.f(bsdf, wo, wi)
            cos_p = torch.abs(vm.dot(dgp["sn"], wi))
            occ = isect.occluded(scene, p, wi, torch.full_like(d2, 1e-3),
                                 torch.sqrt(d2) * (1.0 - 1e-3))
            G = cos_p * cos_l / d2
            val = fr * Le[None, :] * G[:, None]
            live = on_light & emits & ~occ
            return torch.where(live[:, None], val, 0.0)

        with torch.no_grad():
            I_m = integrand(l2d - delta * n_A)
            I_p = integrand(l2d + delta * n_A)
            px = torch.clamp(x.to(torch.int32), 0, W - 1)
            py = torch.clamp(y.to(torch.int32), 0, H - 1)
            adjo = adjoint_fn(px, py, _radiance_at(scene, opts, x, y))
            jump = torch.sum(adjo * (I_m - I_p), -1)
            e_s = v0 + u[:, None] * (v1 - v0)
            graze = torch.abs(vm.dot(n_L, vm.normalize(e_s - p))) > 1e-4
            live = sil & hitm & (s_e > 1.0 + 1e-4) & graze & \
                torch.isfinite(arclen)
            c = torch.where(live, jump * arclen, 0.0) * \
                (float(W * H) * E / M)
        total = total + _live_sum("area", c, n_A, l2d_of, u, lanes, live)
    return total


def boundary_surrogate(scene: SceneData, opts: R.RenderOptions, jump_fn,
                       adjoint_fn=None, n_samples: int = 1024,
                       seed: int = 0, topology=None, terms=TERMS,
                       part=(0, 1)):
    """Every boundary term of `terms`: jump_fn serves the image-space
    terms (primary, shadow, rim); adjoint_fn (dg/dI) the area-light term,
    skipped when None. part=(rank, size): that rank's share of each."""
    total = _zero(scene)
    if "primary" in terms:
        total = total + silhouette_surrogate(
            scene, opts, jump_fn, n_samples, seed, topology=topology,
            part=part)
    if "shadow" in terms:
        total = total + shadow_silhouette_surrogate(
            scene, opts, jump_fn, n_samples, seed + 1, topology=topology,
            part=part)
    if "rim" in terms:
        total = total + sphere_rim_surrogate(
            scene, opts, jump_fn, max(64, n_samples // 4), seed + 2,
            part=part)
    if "area" in terms and adjoint_fn is not None:
        total = total + area_shadow_surrogate(
            scene, opts, adjoint_fn, n_samples, seed + 3, topology=topology,
            part=part)
    return total


def render_loss_with_silhouette(scene: SceneData, opts: R.RenderOptions,
                                px, py, s_idx, target,
                                n_edge_samples: int = 1024, seed: int = 0,
                                topology=None, terms=TERMS, n_total=None,
                                part=(0, 1), device="cuda"):
    """render_loss_fn with the boundary gradients (the same value; autograd
    also carries the visibility terms), on `device` as render_loss_fn.
    The mean-L2 sample loss is (1/n) sum |L - T|^2 over n samples, spp per
    pixel, i.e. about (spp/n) Integral_image |I - T|^2 dx in unit-pixel
    measure: the boundary densities carry spp/n, and their adjoint w.r.t.
    the image is 2 (I - T) spp/n. n is n_total, the count of the whole
    batch when this call sees only a shard of it (train_step_sharded),
    else px's length. part=(rank, size) takes only that rank's block of
    the edge samples, its share scaled by size: like the shard's interior
    mean, an estimate of the whole batch's term, and the mean of the
    ranks' gradients is the whole term."""
    R.require_device("render_loss_with_silhouette()", device)
    scene = R.on_device(scene, device)
    px, py, s_idx, target = (a.to(device) for a in (px, py, s_idx, target))
    interior = render_loss_fn(scene, opts, px, py, s_idx, target, device)
    if topology is None and scene.triangles.count:
        topology = mesh_edges(scene.triangles.idx.cpu().numpy())
    w = smp.samples_per_pixel(opts.sampler) / (n_total or px.shape[0])
    tgt = target.detach()

    def jump_fn(L_m, L_p, jpx, jpy):
        # The loss density's jump across the edge.
        T = tgt[jpy.long(), jpx.long()]
        return (torch.sum((L_m - T) ** 2, -1) -
                torch.sum((L_p - T) ** 2, -1)) * w

    def adjoint_fn(jpx, jpy, I):
        return 2.0 * (I - tgt[jpy.long(), jpx.long()]) * w

    surr = boundary_surrogate(scene, opts, jump_fn, adjoint_fn,
                              n_samples=n_edge_samples, seed=seed,
                              topology=topology, terms=terms,
                              part=part) * part[1]
    return interior + surr - surr.detach()
