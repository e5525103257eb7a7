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
csrc/megakernel.cu runs them; ``wavefront_census`` in the wavefront's:
K0's warps walking their slices of slots with refill, and K1's blocks
tracing the list of their rows' live lanes (``wavefront.k1_block_order``)
with refill, as csrc/wavefront.cu runs them. They are used by the tests
and by chip_smoke's bounds, never by the main path.
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
    warps with none are skipped, as the kernel's warps then are. Any grid
    of warps whose lanes each trace one ray of o, d is culled so
    (``wavefront_census`` passes its lanes in order, ``lanes`` = arange)."""
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


class CensusSpan(NamedTuple):
    """One kernel of a wavefront frame under its warps' cull: the bounces
    it runs, the work of each step of its warps, the live segments entering
    each of its bounces, the rows it runs on (K0: the pool's; K1: the dense
    rows COMPACT kept), and, when checked, how many live lanes' culled hit
    parted from the full sweep's (None: not checked)."""

    span: tuple  # (b_lo, b_hi)
    steps: list  # [CensusStep], one per step of the warps
    live: list  # live segments entering bounces b_lo .. b_hi - 1
    rows: int
    parted: object  # int, or None


def _refill_span(inp: mk.KernelInputs, n_lanes: int, item, start, store, b_lo: int,
                 b_hi: int, exact: bool):
    """Bounces [b_lo, b_hi) of a grid of ``n_lanes`` lanes (warps of 32 in
    order) that each trace a sequence of slots one bounce a step, as the
    refill loops of csrc/wavefront.cu run them: ``item(lanes, j)`` is the
    j-th slot of each lane (-1: none left), ``start(slots)`` the (o [3, n],
    d [3, n], tr [n, 3], state [n]) of slots entering b_lo, and
    ``store(slots, o, d, tr, state, alive)`` takes each slot's path where
    it ends (a miss, an emitter, or b_hi reached alive). Returns
    ([CensusStep], live segments entering each bounce, parted or None)."""
    dev = inp.sweep.device
    idx = torch.arange(n_lanes, device=dev)
    j = torch.zeros((n_lanes,), dtype=torch.int64, device=dev)
    slot = item(idx, j)
    live = slot >= 0
    o = torch.zeros((3, n_lanes), dtype=_F32, device=dev)
    d = torch.zeros_like(o)
    tr = torch.ones((n_lanes, 3), dtype=_F32, device=dev)
    state = torch.zeros((n_lanes,), dtype=torch.int64, device=dev)
    bounce = torch.full((n_lanes,), b_lo, dtype=torch.int64, device=dev)

    def load(lanes):
        o[:, lanes], d[:, lanes], tr[lanes], state[lanes] = start(slot[lanes])
        bounce[lanes] = b_lo

    load(torch.nonzero(live).squeeze(1))
    steps, per_bounce = [], torch.zeros((b_hi - b_lo,), dtype=torch.int64, device=dev)
    parted = 0 if exact else None
    while bool(live.any()):
        act = torch.nonzero(live).squeeze(1)
        per_bounce += torch.bincount(bounce[act] - b_lo, minlength=b_hi - b_lo)
        wc = megakernel_warp_cull(tuple(o), tuple(d), live, idx, inp)
        steps.append(CensusStep(wc.count, int(wc.entered.numel())))
        if exact:
            bt, bi = mk._closest_hit(tuple(o[:, act]), tuple(d[:, act]), inp.sweep)
            parted += int(((wc.bi[act] != bi) | (wc.bt[act].view(torch.int32)
                                                 != bt.view(torch.int32))).sum())
        p = mk.trace_bounces_plain(tuple(o[:, act]), tuple(d[:, act]), tr[act], state[act],
                                   inp, 0, 1)
        o[:, act], d[:, act], tr[act], state[act] = p.o.T, p.d.T, p.tr, p.state
        bounce[act] += 1
        ends = ~p.alive | (bounce[act] == b_hi)
        ended = act[ends]
        store(slot[ended], o[:, ended], d[:, ended], tr[ended], state[ended], p.alive[ends])
        live[ended] = False
        j[ended] += 1
        slot[ended] = item(ended, j[ended])
        nxt = ended[slot[ended] >= 0]
        if nxt.numel():
            load(nxt)
            live[nxt] = True
    return steps, per_bounce.tolist(), parted


def wavefront_census(inp: mk.KernelInputs, t, frame, cuts: tuple, num_bounces: int, *,
                     exact: bool = False) -> list:
    """The work of one wavefront frame (K0, then COMPACT and K1 per cut)
    under the per-warp cull, on the twins' rays, its lanes grouped as
    csrc/wavefront.cu groups them: per kernel a CensusSpan. K0's warps each
    walk ``wavefront.k0_slices(spp)`` slices of 32 slots (a quarter of a
    tile's row, then the same quarter of the rows below), lane l taking
    slot l of each, one bounce a step, the next slot as soon as a path
    ends; K1's blocks take wavefront.K1_ROWS dense rows and thread j traces
    entries j, j + 256, ... of their live lanes in
    ``wavefront.k1_block_order``, refilled the same way. ``t`` is ``wavefront.plan``'s tiling. With
    ``exact`` each live lane's culled hit is held against the full sweep's
    (CensusSpan.parted). Each lane's own counts (``own_*``, ``live``,
    ``prior_tests``) do not depend on the grouping. Rays come from
    ``trace_bounces_plain`` one bounce at a time, as cull_census's."""
    from . import regroup as rg
    from . import wavefront as wf

    k0_slices, k1_rows, k1_threads = wf.k0_slices(t.spp), wf.K1_ROWS, wf._K1_THREADS
    dev = inp.sweep.device
    frame = int(frame) & rng.MASK32
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    inv_w, inv_h = mk._f32(1.0 / t.width), mk._f32(1.0 / t.full_height)
    cap = t.cap
    # each slot's path where its last kernel left it
    so = torch.zeros((3, cap), dtype=_F32, device=dev)
    sd = torch.zeros_like(so)
    str_ = torch.ones((cap, 3), dtype=_F32, device=dev)
    sst = torch.zeros((cap,), dtype=torch.int64, device=dev)
    salive = torch.zeros((cap,), dtype=torch.bool, device=dev)

    def camera(slots):
        st, x, y_g = rg._seeds(t, slots, frame)
        st, o, d = mk.camera_rays_plain(cam, x.to(_F32), y_g.to(torch.int32).to(_F32), inv_w,
                                        inv_h, st)
        return (torch.stack(o), torch.stack(d),
                torch.ones((slots.numel(), 3), dtype=_F32, device=dev), st)

    def stored(slots):
        return so[:, slots], sd[:, slots], str_[slots], sst[slots]

    def store(slots, o, d, tr, state, alive):
        so[:, slots], sd[:, slots], str_[slots], sst[slots] = o, d, tr, state
        salive[slots] = alive

    spans = list(zip((0,) + tuple(cuts), tuple(cuts) + (num_bounces,)))
    out = []
    rows = torch.arange(cap, device=dev).view(-1, wf.LANES)  # the pool's rows of slots
    for k, (b_lo, b_hi) in enumerate(spans):
        if k == 0:
            per_tile = 4 * (wf.TILE_ROWS // k0_slices)  # warps a tile

            def item(lanes, j):
                warp = lanes >> 5
                tile, in_tile = warp // per_tile, warp % per_tile
                at = (tile * wf.TILE_ROWS * wf.LANES + ((in_tile >> 2) * k0_slices + j)
                      * wf.LANES + (in_tile & 3) * 32 + (lanes & 31))
                return torch.where(j < k0_slices, at, torch.full_like(at, -1))
            n_lanes = cap // (wf.TILE_ROWS * wf.LANES) * per_tile * 32
            start = camera
        else:
            rows = rows[salive[rows].any(dim=1)]  # COMPACT: whole live rows, in order
            order, n_live = wf.k1_block_order(salive[rows], k1_rows)
            per = k1_rows * wf.LANES
            blk_slots = torch.cat([rows, rows.new_full(
                (order.shape[0] * k1_rows - rows.shape[0], wf.LANES), -1)]).view(-1, per)

            def item(lanes, j, order=order, n_live=n_live, blk_slots=blk_slots):
                b, at = lanes // k1_threads, lanes % k1_threads + k1_threads * j
                ok = at < n_live[b]
                e = order[b, at.clamp(max=per - 1)].clamp(min=0)
                return torch.where(ok, blk_slots[b, e], torch.full_like(lanes, -1))
            n_lanes = order.shape[0] * k1_threads
            start = stored
        steps, live, parted = _refill_span(inp, n_lanes, item, start, store, b_lo, b_hi, exact)
        out.append(CensusSpan((b_lo, b_hi), steps, live, int(rows.shape[0]), parted))
    return out


__all__ = ["CensusSpan", "CensusStep", "CullCount", "WarpCull", "lane_margin",
           "megakernel_census", "megakernel_lanes", "megakernel_warp_cull", "warp_cull_plain",
           "wavefront_census"]
