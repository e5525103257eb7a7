"""The frame's COMBINE twin against the JAX package's per-level combine, on
the CPU.

``regroup.combine_chain_plain`` is the twin of the one-launch CUDA COMBINE:
it follows each home slot's inverse maps to the phase its record ended in
and folds the radiance it finds there. ``regroup.combine_plain`` is one
reverse-combine level of the JAX package, held against the JAX level
kernel in interpret mode by tests/test_torch_regroup.py. Here the chain
twin must give, in every bit, what the levels give when they run as the
JAX package runs them (k = n, ..., 2, then the home level with the fold),
on the twins' own pools from RTiOW frames (K0, then PACK and K1 at each
cut): 96x64 at 1, 4 and 32 spp with cuts (2,) and (2, 4, 6), a 100x70
image (ragged in x and y), and the 96x64 frame with every record dead
before PACK 1 and with every record alive to the last phase. Each case
folds onto a random accumulator and with ``clear``, and neither COMBINE
changes its inputs. The frames are built once per module, on one PyTorch
thread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch import (SCENES, CameraBasis, SkyParams,  # noqa: E402
                                         to_sky_state)
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

_BOUNCES = 8
# case -> (width, height, spp, cuts, alive: None = the frame's own, else the
# value every record's alive flag is set to before each PACK)
_CASES = {
    "96x64_spp1_cut2": (96, 64, 1, (2,), None),
    "96x64_spp1_cuts246": (96, 64, 1, (2, 4, 6), None),
    "96x64_spp4_cut2": (96, 64, 4, (2,), None),
    "96x64_spp4_cuts246": (96, 64, 4, (2, 4, 6), None),
    "96x64_spp32_cut2": (96, 64, 32, (2,), None),
    "96x64_spp32_cuts246": (96, 64, 32, (2, 4, 6), None),
    "100x70_spp4_cuts246": (100, 70, 4, (2, 4, 6), None),
    "all_dead_before_pack1": (96, 64, 4, (2, 4, 6), 0.0),
    "all_live_to_the_last_phase": (96, 64, 4, (2, 4, 6), 1.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chain(w, h, spp, cuts, alive):
    """The twins' frame 0 up to COMBINE: (tiling, inverse maps [n, cap],
    radiance [n, 3, cap], K0's contributions [3, cap], counts)."""
    desc, cam = SCENES["rtiow"][0](), SCENES["rtiow"][1]()
    inp = mk.kernel_inputs(desc.build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                           CameraBasis.create(cam, (w, h), device="cpu"))
    t, cuts = rg.plan(w, h, spp, _BOUNCES, cuts)
    pools = [torch.empty((rg.N_COMP, t.cap)) for _ in range(2)]
    contrib = torch.empty((3, t.cap))
    inv = torch.empty((len(cuts), t.cap), dtype=torch.int32)
    r8 = torch.empty((len(cuts), 3, t.cap))
    counts = torch.full((len(cuts) + 1,), t.cap, dtype=torch.int32)
    rg.k0_plain(inp, pools[0], contrib, t, 0, cuts[0])
    for k, b_lo in enumerate(cuts, 1):
        src, dst = pools[(k - 1) % 2], pools[k % 2]
        if alive is not None:
            src[rg._AL] = alive
        rg.pack_plain(src, dst, inv[k - 1], counts, k)
        b_hi = cuts[k] if k < len(cuts) else _BOUNCES
        rg.k1_plain(inp, dst, r8[k - 1], counts, k, t, 0, b_lo, b_hi)
    return t, inv, r8, contrib, counts


@pytest.fixture(scope="module")
def chains():
    """Each case's chain, built on first use and kept for the module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _chain(*_CASES[case])
        return cache[case]

    return get


def _levels(inv, r8, contrib, counts, accum, t, clear):
    """The JAX package's order: the levels from the last phase down, each
    over a copy of the phase's base radiance, then the home level's fold."""
    radiance = r8[-1]
    for k in range(inv.shape[0], 1, -1):
        base = r8[k - 2].clone()
        rg.combine_plain(inv[k - 1], radiance, base, counts, k)
        radiance = base
    rg.combine_plain(inv[0], radiance, contrib.clone(), counts, 1, accum=accum, t=t,
                     clear=clear)


def _bits(a):
    return (a + 0.0).view(torch.int32)


@pytest.mark.parametrize("case", list(_CASES))
def test_combine_chain_equals_the_levels(case, chains):
    t, inv, r8, contrib, counts = chains(case)
    alive = _CASES[case][4]
    live = counts.tolist()
    if alive == 0.0:
        assert live[1:] == [0] * (len(live) - 1) and not bool((inv[0] >= 0).any())
    elif alive == 1.0:
        assert live == [t.cap] * len(live)
    else:
        assert t.cap > live[1] > 0 and all(a >= b for a, b in zip(live, live[1:]))
    kept = [x.clone() for x in (inv, r8, contrib, counts)]
    accum = torch.from_numpy(
        np.random.RandomState(7).standard_normal((t.width * t.height, 3)).astype(np.float32))
    for clear in (False, True):
        got, ref = accum.clone(), accum.clone()
        rg.combine_chain_plain(inv, r8, contrib, got, t, clear)
        _levels(inv, r8, contrib, counts, ref, t, clear)
        assert torch.equal(_bits(got), _bits(ref)), clear
        assert bool(torch.isfinite(got).all())
    # (past each count the buffers hold what torch.empty gave: compare bits)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(kept, (inv, r8, contrib, counts)))
