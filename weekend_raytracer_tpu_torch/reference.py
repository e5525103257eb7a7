"""Host reference tracer: an independent NumPy implementation.

Counterpart of weekend_raytracer_tpu/reference.py: a from-scratch NumPy
implementation of the same algorithm (RTiOW-style path tracing with the
reference's sampling scheme), the golden oracle for the port's ``"xla"``
backend and its fused kernels. It shares no tracer code with the device
paths; only the model *data* builders (``models/``) are the port's own, so
it imports no JAX. Its arithmetic is the JAX package's oracle's, line for
line, so on the same scene data the two give the same bits.

The RNG matches ops/rng.py bit for bit, so images are comparable at small
sample counts with tight tolerances.
"""
from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
MIN_T, MAX_T = 1.0e-3, 1.0e3
EPS = 1.0e-3


# --- RNG (independent reimplementation of wgsl:498-521) ---

def jenkins(x):
    x = x.astype(np.uint64)
    x = (x + (x << np.uint64(10))) & M32
    x ^= x >> np.uint64(6)
    x = (x + (x << np.uint64(3))) & M32
    x ^= x >> np.uint64(11)
    x = (x + (x << np.uint64(15))) & M32
    return x


def pcg_next(state):
    old = (state + np.uint64(747796405) + np.uint64(2891336453)) & M32
    shift = (old >> np.uint64(28)) + np.uint64(4)
    word = (((old >> shift) ^ old) * np.uint64(277803737)) & M32
    return ((word >> np.uint64(22)) ^ word) & M32


def init_state(pixel_idx, frame):
    return jenkins(pixel_idx.astype(np.uint64) ^ jenkins(np.uint64(frame)))


def next_float(state):
    state = pcg_next(state)
    return state, (state >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def _np(a):
    """A tensor (on any device) or array as a numpy array."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


# --- geometry helpers ---

def normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def pixar_onb(n):
    s = np.where(n[:, 2] >= 0.0, 1.0, -1.0).astype(np.float32)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    u = np.stack([1.0 + s * n[:, 0] ** 2 * a, s * b, -s * n[:, 0]], -1)
    v = np.stack([b, s + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return u, v


def reflect(d, n):
    return d - 2.0 * (d * n).sum(-1, keepdims=True) * n


class OracleTracer:
    """Path-traces a SceneDesc with NumPy; mirrors ops/tracer.py semantics."""

    def __init__(self, desc, camera, width, height, sky_params=None,
                 sky_state=None):
        from .models.camera import CameraBasis
        from .models.materials import MaterialTable
        from .models.sky import SkyParams, to_sky_state

        self.width, self.height = width, height
        self.centers = np.asarray([s.center for s in desc.spheres], np.float32)
        self.radii = np.asarray([s.radius for s in desc.spheres], np.float32)
        self.smat = np.asarray([s.material_idx for s in desc.spheres], np.int32)
        table = MaterialTable.build(desc.materials, device="cpu")
        self.mid = _np(table.ids)
        self.mtex1 = _np(table.tex1)
        self.mtex2 = _np(table.tex2)
        self.mx = _np(table.x)
        self.pool = _np(table.pool)
        basis = CameraBasis.create(camera, (width, height), device="cpu")
        self.basis = {k: _np(getattr(basis, k)) for k in
                      ("eye", "horizontal", "vertical", "u", "v",
                       "lens_radius", "lower_left_corner")}
        st = (sky_state if sky_state is not None
              else to_sky_state(sky_params or SkyParams(), device="cpu"))
        self.sky_params_arr = _np(st.params)
        self.sky_radiances = _np(st.radiances)
        self.sun = _np(st.sun_direction)

    # -- sky (wgsl:316-343) --
    def sky(self, d):
        v = normalize(d)
        theta = np.arccos(np.clip(v[:, 1], -1, 1))[:, None]
        gamma = np.arccos(np.clip(v @ self.sun, -1, 1))[:, None]
        p = self.sky_params_arr
        cg = np.cos(gamma)
        ct = np.abs(np.cos(theta))
        mie = (1 + cg**2) / np.power(1 + p[:, 8]**2 - 2 * p[:, 8] * cg, 1.5)
        lhs = 1 + p[:, 0] * np.exp(p[:, 1] / (ct + 0.01))
        rhs = (p[:, 2] + p[:, 3] * np.exp(p[:, 4] * gamma) + p[:, 5] * cg**2
               + p[:, 6] * mie + p[:, 7] * np.sqrt(ct))
        return (self.sky_radiances * lhs * rhs).astype(np.float32)

    # -- closest hit --
    def intersect(self, o, d):
        oc = o[:, None, :] - self.centers[None]
        b = (oc * d[:, None, :]).sum(-1)
        c = (oc * oc).sum(-1) - self.radii**2
        disc = b * b - c
        sq = np.sqrt(np.maximum(disc, 0.0))
        t0, t1 = -b - sq, -b + sq
        ok = disc > 0
        near = ok & (t0 > MIN_T) & (t0 < MAX_T)
        far = ok & (t1 > MIN_T) & (t1 < MAX_T)
        t = np.where(near, t0, np.where(far, t1, MAX_T))
        idx = t.argmin(1)
        tmin = t[np.arange(len(t)), idx]
        return tmin.astype(np.float32), idx.astype(np.int32), tmin < MAX_T

    def tex(self, desc, u, v):
        w, h, off = desc[:, 0], desc[:, 1], desc[:, 2]
        uu = np.clip(u, 0, 1)
        vv = 1 - np.clip(v, 0, 1)
        j = np.minimum((uu * w).astype(np.int32), w - 1)
        i = np.minimum((vv * h).astype(np.int32), h - 1)
        return self.pool[off + i * w + j]

    def render(self, spp, bounces, frame=0, on_bounce=None, pixels=None):
        """on_bounce(sample, bounce, o, d, alive), called at the start of
        every bounce segment, exposes the exact mid-path ray populations
        without reading a device's ray pools.

        pixels restricts tracing to the given flat pixel indices (camera
        geometry and RNG seeds stay full-frame exact); the return is then
        the unreshaped (len(pixels), 3) accumulator."""
        W, H = self.width, self.height
        if pixels is None:
            n = W * H
            pix = np.arange(n, dtype=np.uint64)
        else:
            pix = np.asarray(pixels, dtype=np.uint64)
            n = pix.shape[0]
        x = (pix % W).astype(np.float32)
        y = (pix // W).astype(np.float32)
        acc = np.zeros((n, 3), np.float32)
        for s in range(spp):
            # independent per-sample seed (matches ops/rng.init_sample_state)
            mix = np.uint64((0x9E3779B9 * (s + 1)) & 0xFFFFFFFF)
            state = jenkins(pix ^ jenkins(np.uint64(frame)) ^ mix)
            state, ju = next_float(state)
            state, jv = next_float(state)
            state, dr = next_float(state)
            state, da = next_float(state)
            su = (x + ju) / W
            sv = 1.0 - (y + jv) / H
            r = np.sqrt(dr)
            alpha = 2 * np.pi * da
            b = self.basis
            lens = (b["lens_radius"] * r * np.cos(alpha))[:, None] * b["u"] + \
                   (b["lens_radius"] * r * np.sin(alpha))[:, None] * b["v"]
            o = b["eye"] + lens
            d = (b["lower_left_corner"] + su[:, None] * b["horizontal"]
                 + sv[:, None] * b["vertical"] - o)
            d = normalize(d).astype(np.float32)
            o = o.astype(np.float32)

            thr = np.ones((n, 3), np.float32)
            col = np.zeros((n, 3), np.float32)
            alive = np.ones(n, bool)
            for _b in range(bounces):
                if on_bounce is not None:
                    on_bounce(s, _b, o, d, alive)
                t, sidx, hit = self.intersect(o, d)
                cen = self.centers[sidx]
                rad = self.radii[sidx]
                p = o + t[:, None] * d
                nrm = (p - cen) / np.where(rad == 0, 1, rad)[:, None]
                theta = np.arccos(np.clip(-nrm[:, 1], -1, 1))
                phi = np.arctan2(-nrm[:, 2], nrm[:, 0]) + np.pi
                u = phi / (2 * np.pi)
                v = theta / np.pi

                state, r1 = next_float(state)
                state, r2 = next_float(state)
                state, r3 = next_float(state)
                state, r4 = next_float(state)

                mat = self.smat[sidx]
                mid = self.mid[mat]
                mx = self.mx[mat]
                alb1 = self.tex(self.mtex1[mat], u, v)
                alb2 = self.tex(self.mtex2[mat], u, v)

                # diffuse direction
                sq2 = np.sqrt(r2)
                z = np.sqrt(np.maximum(0, 1 - r2))
                ph = 2 * np.pi * r1
                tu, tv = pixar_onb(nrm)
                dif = (np.cos(ph) * sq2)[:, None] * tu + \
                      (np.sin(ph) * sq2)[:, None] * tv + z[:, None] * nrm
                ndw = (nrm * dif).sum(-1)
                # eval/pdf with the device paths' exact clamping:
                # (1/pi * max(EPS, n.wi)) / max(EPS, n.wi / pi)
                frac_1_pi = 1.0 / np.pi
                lam_ratio = (
                    frac_1_pi * np.maximum(EPS, ndw)
                    / np.maximum(EPS, ndw * frac_1_pi)
                )[:, None]

                # unit ball point
                rr = np.cbrt(r1)
                cth = 1 - 2 * r2
                sth = np.sqrt(np.maximum(0, 1 - cth**2))
                ph3 = 2 * np.pi * r3
                ball = np.stack([rr * sth * np.cos(ph3), rr * sth * np.sin(ph3),
                                 rr * cth], -1)

                sines = np.sin(5 * p[:, 0]) * np.sin(5 * p[:, 1]) * np.sin(5 * p[:, 2])
                chk = np.where((sines < 0)[:, None], alb1, alb2)

                refl = reflect(d, nrm)
                metal_dir = refl + mx[:, None] * ball

                ddn = (d * nrm).sum(-1)
                front = ddn < 0
                onrm = np.where(front[:, None], nrm, -nrm)
                mx_safe = np.where(mx == 0, 1.0, mx)  # non-dielectric lanes
                eta = np.where(front, 1.0 / mx_safe, mx)
                cosine = np.where(front, -ddn, mx * ddn)
                dt = (d * onrm).sum(-1)
                disc = 1 - eta**2 * (1 - dt**2)
                can = disc > 0
                refr = eta[:, None] * (d - dt[:, None] * onrm) - \
                    np.sqrt(np.maximum(disc, 0))[:, None] * onrm
                r0 = ((1 - mx) / (1 + mx)) ** 2
                schl = r0 + (1 - r0) * (1 - np.clip(cosine, 0, 1)) ** 5
                rp = np.where(can, schl, 1.0)
                diel_dir = np.where((r4 < rp)[:, None], refl, refr)

                new_d = np.where((mid == 0)[:, None], dif,
                         np.where((mid == 1)[:, None], metal_dir,
                          np.where((mid == 2)[:, None], diel_dir,
                           np.where((mid == 3)[:, None], dif,
                                    nrm + ball))))
                new_thr = np.where((mid == 0)[:, None], alb1 * lam_ratio,
                           np.where((mid == 1)[:, None], alb1,
                            np.where((mid == 2)[:, None], np.ones_like(alb1),
                             np.where((mid == 3)[:, None], chk * lam_ratio,
                                      np.tile([0.9921, 0.24705, 0.57254],
                                              (n, 1)).astype(np.float32)))))
                new_d = normalize(new_d).astype(np.float32)

                sky_rgb = self.sky(d)
                active = alive & hit
                missed = alive & ~hit
                lit = active & (mid == 4)  # emissive: path ends here
                scattering = active & (mid != 4)
                thr = np.where(scattering[:, None], thr * new_thr, thr)
                col = np.where(missed[:, None], sky_rgb, col)
                col = np.where(lit[:, None], mx[:, None] * alb1, col)
                o = np.where(scattering[:, None], p, o).astype(np.float32)
                d = np.where(scattering[:, None], new_d, d)
                alive = scattering
            acc += thr * col
        return acc if pixels is not None else acc.reshape(H, W, 3)
