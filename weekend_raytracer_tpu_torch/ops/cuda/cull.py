"""The per-warp chunk cull of regroup K0 and K1, in plain PyTorch.

``warp_cull_plain`` is the twin of the decisions of csrc/bounce.cuh's
``sweep_culled``: rays in groups of ``group`` consecutive lanes (a warp of
K0's slots or of K1's dense records), the priors' bound ``pbt`` first, then
per super-chunk and per chunk of an entered one the TPU's slab test of each
live lane, on the box widened by the lane's own margin (``lane_margin``,
megakernel.py CULL_MARGIN_ULPS), against min(pbt, best-t), and a group
sweeps a chunk's spheres, in index order, iff one of its live lanes enters
it; last, the priors' own closest hit joins the result by (t, index). It
returns the closest hit computed that way, which is the full sweep's in
every bit, and two counts of work: what each live lane's own decisions
need (K0's and K1's bounds) and what the lanes do under the warp vote
(the design's work). ``regroup.cull_census`` runs it over a frame in
K0's and K1's groups; ``megakernel_census`` in the megakernel's, whose
warps are 16 x 2 pixel patches of its 16 x 16 blocks (``megakernel_lanes``),
with the lanes of a warp in step (one sample and bounce at a time) or
each at its own place in its pixel's samples, as the refill loop of
csrc/megakernel.cu runs them. They are used by the tests and by
chip_smoke's bounds, never by the main path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng
from ..intersect import MAX_T
from . import megakernel as mk

_F32 = torch.float32
_WARP = 32
_MEGAKERNEL_BLOCK = (16, 16)  # csrc/megakernel.cu kBlockX, kBlockY
_CENSUS_LANES = 1 << 21  # lanes per batch of megakernel_census (whole warps)


class CullCount(NamedTuple):
    """Work of the live lanes of one bounce: under the warp vote, and what
    each lane's own decisions need."""

    live: int  # live lanes: path segments
    sphere_tests: int  # sphere tests in the chunks their groups sweep
    prior_tests: int  # the priors' sphere tests (N_PRIORS a segment; 0 unculled)
    box_tests: int  # super-chunk and chunk slab tests their groups run
    own_sphere_tests: int  # sphere tests in the chunks each lane enters itself
    own_box_tests: int  # super-chunk boxes, and chunk boxes of the supers it enters

    def plus(self, other: "CullCount") -> "CullCount":
        return CullCount(*(a + b for a, b in zip(self, other)))


class CensusStep(NamedTuple):
    """One step of the megakernel's warps: the work of their live lanes,
    and how many warps ran it (those with a live lane)."""

    count: CullCount
    warps: int


class WarpCull(NamedTuple):
    bt: torch.Tensor  # [n] f32 closest hit distance, MAX_T where none
    bi: torch.Tensor  # [n] i64 its sphere, -1 where none
    count: CullCount
    entered: torch.Tensor  # [groups] i64 chunks each group swept


def _group_any(mask: torch.Tensor, group: int) -> torch.Tensor:
    """[groups] bool: whether any lane of each group of ``group`` is set."""
    n = mask.shape[0]
    pad = -n % group
    if pad:
        mask = torch.cat([mask, mask.new_zeros((pad,))])
    return mask.view(-1, group).any(dim=1)


def _lanes(per_group: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """[n] bool: the lanes of the groups set in ``per_group``."""
    return per_group.repeat_interleave(group)[:n]


def lane_margin(o, inp: mk.KernelInputs) -> torch.Tensor:
    """[n] f32: how far each lane at origin o widens the boxes it tests,
    cull_scale * (|o| + cull_reach)^2, as csrc/bounce.cuh sweep_culled
    computes it (megakernel.py CULL_MARGIN_ULPS)."""
    ox, oy, oz = o
    reach = torch.sqrt(ox * ox + oy * oy + oz * oz) + mk._f32(inp.cull_reach)
    return mk._f32(inp.cull_scale) * reach * reach


def warp_cull_plain(o, d, alive, inp: mk.KernelInputs, group: int = 32) -> WarpCull:
    """One bounce's closest hit, computed as K0 and K1 cull it.

    o and d are (x, y, z) tuples of [n] f32 in lane order, ``alive`` [n]
    bool the lanes that sweep (dead lanes never vote; the last group may be
    short). Lanes swept along by their group get their hit too; a live
    lane's (bt, bi) is the full sweep's. A lane's own decisions do not
    depend on its group (its bound before each chunk is the full sweep's),
    so the ``own_*`` counts are those of ``group = 1``. Without a chunk
    hierarchy every live lane tests every sphere, as the kernels then do."""
    n = o[0].shape[0]
    dev = o[0].device
    alive = alive.to(torch.bool)
    live = int(alive.sum())
    groups = -(-n // group)
    entered = torch.zeros((groups,), dtype=torch.int64, device=dev)
    if not inp.n_chunks:
        bt, bi = mk._closest_hit(o, d, inp.sweep)
        full = live * inp.n_spheres
        return WarpCull(bt, bi, CullCount(live, full, 0, 0, full, 0), entered)
    od, oo = mk._od_oo(o, d)
    # the priors' closest hit, least (t, index) first
    pbt = torch.full((n,), MAX_T, dtype=_F32, device=dev)
    pbi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for p in inp.prior_idx.tolist():
        ts = mk._sphere_ts(o, d, od, oo, inp.sweep[p:p + 1])[:, 0]
        take = (ts < MAX_T) & ((ts < pbt) | ((ts == pbt) & (p < pbi)))
        pbt = torch.where(take, ts, pbt)
        pbi = torch.where(take, p, pbi)
    inv = [1.0 / (torch.where(v >= 0.0, 1.0, -1.0).to(_F32)
                  * torch.clamp(torch.abs(v), min=1.0e-12)) for v in d]
    m = lane_margin(o, inp)
    bt = torch.full((n,), MAX_T, dtype=_F32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sphere_tests = box_tests = own_sphere = own_box = 0
    cs = inp.chunk_size
    per = inp.super_factor if inp.n_super else inp.n_chunks
    for c0 in range(0, inp.n_chunks, per):
        mine = alive
        testing = live  # live lanes that run the chunk tests of this span
        if inp.n_super:
            s = c0 // per
            mine = alive & mk._slab_enters(inp.super_bounds[:, s:s + 1], o, inv,
                                           torch.minimum(pbt, bt)[:, None], m)[:, 0]
            box_tests += live
            own_box += live
            in_super = _group_any(mine, group)
            if not bool(in_super.any()):
                continue
            testing = int((alive & _lanes(in_super, n, group)).sum())
        own_testing = int(mine.sum())
        for c in range(c0, min(c0 + per, inp.n_chunks)):
            enters = mine & mk._slab_enters(inp.chunk_bounds[:, c:c + 1], o, inv,
                                            torch.minimum(pbt, bt)[:, None], m)[:, 0]
            box_tests += testing
            own_box += own_testing
            own_sphere += cs * int(enters.sum())
            vote = _group_any(enters, group)
            if not bool(vote.any()):
                continue
            entered += vote
            lanes = torch.nonzero(_lanes(vote, n, group)).squeeze(1)
            ts = mk._sphere_ts(tuple(v[lanes] for v in o), tuple(v[lanes] for v in d),
                               od[lanes], oo[lanes], inp.sweep[c * cs:(c + 1) * cs])
            tm, im = torch.min(ts, dim=1)  # the first index of the chunk's least t
            old_t, old_i = bt[lanes], bi[lanes]
            better = tm < old_t
            bt[lanes] = torch.where(better, tm, old_t)
            bi[lanes] = torch.where(better, im + c * cs, old_i)
            sphere_tests += cs * int(alive[lanes].sum())
    take = (pbi >= 0) & ((pbt < bt) | ((pbt == bt) & (pbi < bi)))
    bt = torch.where(take, pbt, bt)
    bi = torch.where(take, pbi, bi)
    count = CullCount(live, sphere_tests, mk.N_PRIORS * live, box_tests, own_sphere, own_box)
    return WarpCull(bt, bi, count, entered)


def megakernel_lanes(width: int, height: int) -> torch.Tensor:
    """[lanes] i64: the pixel (y * width + x) of each lane of the
    megakernel's grid of 16 x 16-thread blocks, block after block, lanes
    x-fastest within a block, so that each 32 consecutive lanes are one
    warp; -1 for a lane past the image edge, which returns at once."""
    bx, by = _MEGAKERNEL_BLOCK
    gx, gy = -(-width // bx), -(-height // by)
    t = torch.arange(bx * by)
    b = torch.arange(gx * gy)
    x = ((b % gx) * bx)[:, None] + (t % bx)[None, :]
    y = ((b // gx) * by)[:, None] + (t // bx)[None, :]
    return torch.where((x < width) & (y < height), y * width + x,
                       torch.full_like(x, -1)).reshape(-1)


def megakernel_warp_cull(o, d, live, lanes, inp: mk.KernelInputs) -> WarpCull:
    """One bounce's closest hit of the pixels' rays o, d ((x, y, z) tuples
    of [pixels] f32), alive where ``live`` [pixels], computed as the
    megakernel's warps cull it: the lanes of ``megakernel_lanes`` (a pixel
    per lane, -1 none) in groups of 32. (bt, bi) are per pixel (MAX_T, -1
    for a pixel not live), ``entered`` per warp that has a live lane;
    warps with none are skipped, as the kernel's warps then are."""
    dev = o[0].device
    n = o[0].shape[0]
    alive = (lanes >= 0) & live[lanes.clamp(min=0)]
    warps = torch.nonzero(alive.view(-1, _WARP).any(dim=1)).squeeze(1)
    sel = (warps[:, None] * _WARP + torch.arange(_WARP, device=dev)).reshape(-1)
    bt = torch.full((n,), MAX_T, dtype=_F32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    count = CullCount(0, 0, 0, 0, 0, 0)
    entered = []
    for lo in range(0, sel.numel(), _CENSUS_LANES):
        idx = sel[lo:lo + _CENSUS_LANES]
        pix = lanes[idx].clamp(min=0)
        wc = warp_cull_plain(tuple(v[pix] for v in o), tuple(v[pix] for v in d), alive[idx],
                             inp, _WARP)
        mine = alive[idx]
        bt[pix[mine]], bi[pix[mine]] = wc.bt[mine], wc.bi[mine]
        count = count.plus(wc.count)
        entered.append(wc.entered)
    entered = torch.cat(entered) if entered else torch.zeros((0,), dtype=torch.int64,
                                                              device=dev)
    return WarpCull(bt, bi, count, entered)


def megakernel_census(inp: mk.KernelInputs, width: int, height: int, spp: int,
                      num_bounces: int, frame, *, refill: bool) -> list:
    """The work of one megakernel frame under the per-warp cull, on the
    twin's rays: [CensusStep] per step of the warps. ``refill=False``
    groups the lanes in step, every lane of a warp at the same sample and
    bounce (a lane whose path ended sits out), as a loop of one sample
    after another runs them (the stats megakernel's), one
    count per (sample, bounce) in that order; ``refill=True`` as the
    refill loop does, each lane one bounce a step of its own pixel's
    samples in turn (a path that ends starts the pixel's next sample at
    the next step), one count per step until every pixel has done its
    ``spp`` samples. Each step is a CensusStep: its CullCount and the warps
    that ran it. Each lane's own counts (``own_*``, ``live``,
    ``prior_tests``) do not depend on the grouping. Rays come from
    ``trace_bounces_plain`` one bounce at a time, as cull_census's."""
    dev = inp.sweep.device
    frame = int(frame) & rng.MASK32
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    inv_w, inv_h = mk._f32(1.0 / width), mk._f32(1.0 / height)
    lanes = megakernel_lanes(width, height).to(dev)
    n = width * height
    idx = torch.arange(n, device=dev)
    x, y = idx % width, idx // width
    pix = y * width + x

    def camera(sel, sample):
        st = rng.init_sample_state(pix[sel], frame, sample)
        st, o, d = mk.camera_rays_plain(cam, x[sel].to(_F32), y[sel].to(_F32), inv_w, inv_h,
                                        st)
        return st, torch.stack(o), torch.stack(d)

    o = torch.empty((3, n), dtype=_F32, device=dev)
    d = torch.empty_like(o)
    tr = torch.ones((n, 3), dtype=_F32, device=dev)
    sample = torch.zeros((n,), dtype=torch.int64, device=dev)
    bounce = torch.zeros_like(sample)
    state, o[:], d[:] = camera(idx, 0)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    out = []
    while bool(live.any()):
        wc = megakernel_warp_cull(tuple(o), tuple(d), live, lanes, inp)
        out.append(CensusStep(wc.count, int(wc.entered.numel())))
        act = torch.nonzero(live).squeeze(1)
        p = mk.trace_bounces_plain(tuple(o[:, act]), tuple(d[:, act]), tr[act], state[act],
                                   inp, 0, 1)
        o[:, act], d[:, act], tr[act], state[act] = p.o.T, p.d.T, p.tr, p.state
        bounce[act] += 1
        ended = act[~p.alive | (bounce[act] == num_bounces)]
        live[ended] = False
        if refill:
            sample[ended] += 1
            nxt = ended[sample[ended] < spp]
        elif not bool(live.any()) and int(sample[0]) + 1 < spp:
            sample += 1
            nxt = idx
        else:
            continue
        if nxt.numel():
            state[nxt], o[:, nxt], d[:, nxt] = camera(nxt, sample[nxt])
            tr[nxt] = 1.0
            bounce[nxt] = 0
            live[nxt] = True
    return out


__all__ = ["CensusStep", "CullCount", "WarpCull", "lane_margin", "megakernel_census",
           "megakernel_lanes", "megakernel_warp_cull", "warp_cull_plain"]
