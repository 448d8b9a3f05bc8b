"""The binned tracer's emission (stratum_tpu_torch/ops/binned.py, step 1)
against a numpy loop and against the JAX reference's emission stats, and the
emission kernel's choice of leaf tiles (its run on the card is in
tests/test_torch_cuda.py).

The plain emission ``_emit`` is the emission kernel's plain version. Both
compute the slab tests with subtract, multiply, min, max and compares only,
which numpy f32 computes the same way, so count and slots must equal the
numpy loop bit for bit: for g in {1, 8, 16, 128}, both emission modes, a
small ``pcap`` (overflowing groups) and a large one, on the tiny atrium's
rays with dead lanes and a block of all-dead groups. The reference's stats
(pairs and pcap drops, which pin every group's raw count) must equal the
port's for the group sizes test_torch_binned.py does not cover. Inputs are
made with numpy from fixed seeds and go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import binned as jbinned
from stratum_tpu.render import camera as jcamera
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import binned, block_trace
from stratum_tpu_torch.ops.intersect import T_MAX
from stratum_tpu_torch.scene import bridge

torch.set_num_threads(2)

MCAP = 1 << 15  # above every case's pair count
BIG = np.float32(3.0e38)


@pytest.fixture(scope="module")
def wave():
    """The tiny atrium (13 SAH leaves) and 4096 rays: camera rays and rays
    from inside the hall, every 7th lane dead, some short bounds, and rays
    256-511 all dead (whole dead groups for every g up to 128)."""
    rng = np.random.default_rng(11)
    g = jbuiltin.atrium(columns=1, stacks=6, slices=12)
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    view = jcamera.make_view(node.to_world(), cam.fovy, 64, 32)
    px, py = jcamera.pixel_grid(64, 32)
    jit = jnp.asarray(rng.random((2048, 2), dtype=np.float32))
    o_cam, d_cam = jcamera.generate_rays(view, px, py, jit, 64, 32)
    o_rand = rng.uniform([-11, 0.2, -39], [11, 9.5, 39], (2048, 3)).astype(np.float32)
    d_rand = rng.normal(size=(2048, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o_cam), o_rand]).astype(np.float32)
    d = np.concatenate([np.asarray(d_cam), d_rand]).astype(np.float32)
    t_max = np.full(o.shape[0], T_MAX, np.float32)
    t_max[::7] = 0.0
    t_max[3::7] = rng.uniform(0.5, 30.0, t_max[3::7].shape).astype(np.float32)
    t_max[256:512] = 0.0
    return dict(jfat=js.fat_bvh, packed=js.leaf_feat_packed,
                fat=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu").fat_bvh,
                o=o, d=d, t_max=t_max)


def _emit_numpy(lo, hi, o, inv, tb, t_min, g, pcap, em):
    """The emission as a numpy loop over groups (f32 throughout)."""
    n, L = o.shape[0], lo.shape[0]
    ng = n // g
    t_min = np.float32(t_min)
    with np.errstate(over="ignore", invalid="ignore"):
        if em == "ray":
            t0 = (lo[None] - o[:, None]) * inv[:, None]  # [n, L, 3]
            t1 = (hi[None] - o[:, None]) * inv[:, None]
            tn = np.maximum(np.minimum(t0, t1).max(axis=-1), np.float32(0.0))
            tf = np.maximum(t0, t1).min(axis=-1)
            p = (tn <= tf) & (tf >= t_min) & (tn < tb[:, None])
            pg = p.reshape(ng, g, L).any(axis=1)
        else:
            alive = (tb > 0)[:, None]
            o_lo = np.where(alive, o, BIG).reshape(ng, g, 3).min(axis=1)
            o_hi = np.where(alive, o, -BIG).reshape(ng, g, 3).max(axis=1)
            i_lo = np.where(alive, inv, BIG).reshape(ng, g, 3).min(axis=1)
            i_hi = np.where(alive, inv, -BIG).reshape(ng, g, 3).max(axis=1)
            tb_g = tb.reshape(ng, g).max(axis=1)
            tn = np.zeros((ng, L), np.float32)
            tf = np.full((ng, L), BIG, np.float32)
            for a in range(3):
                mins, maxs = [], []
                for b in (lo[None, :, a], hi[None, :, a]):
                    u_lo, u_hi = b - o_hi[:, a:a + 1], b - o_lo[:, a:a + 1]
                    p = np.stack([u_lo * i_lo[:, a:a + 1], u_lo * i_hi[:, a:a + 1],
                                  u_hi * i_lo[:, a:a + 1], u_hi * i_hi[:, a:a + 1]])
                    mins.append(p.min(axis=0))
                    maxs.append(p.max(axis=0))
                tn = np.maximum(tn, np.minimum(*mins))
                tf = np.minimum(tf, np.maximum(*maxs))
            pg = (tn <= tf) & (tf >= t_min) & (tn < tb_g[:, None]) & (tb_g > 0)[:, None]
    count = pg.sum(axis=1).astype(np.int32)
    slots = np.full((ng, pcap), -1, np.int32)
    for i in range(ng):
        leaves = np.nonzero(pg[i])[0][:pcap]
        slots[i, :leaves.size] = leaves
    return count, slots


def _padded(w, g):
    return binned.pad_wave(*(torch.from_numpy(w[k]) for k in ("o", "d", "t_max")), g)


@pytest.mark.parametrize("em", ["ray", "group"])
@pytest.mark.parametrize("g", [1, 8, 16, 128])
def test_emission_matches_a_numpy_loop(wave, g, em):
    fat = wave["fat"]
    o, inv, tb = _padded(wave, g)
    for pcap in (3, 32):
        count, slots = binned._emit(fat, o, inv, tb, block_trace.T_MIN, g, pcap, em)
        want_c, want_s = _emit_numpy(fat.leaf_lo.numpy(), fat.leaf_hi.numpy(), o.numpy(),
                                     inv.numpy(), tb.numpy(), block_trace.T_MIN, g, pcap, em)
        np.testing.assert_array_equal(count.numpy(), want_c)
        np.testing.assert_array_equal(slots.numpy(), want_s)
        assert (want_c > 0).sum() > 10
        dead = slice(256 // g, 512 // g)  # the all-dead groups emit nothing
        assert not want_c[dead].any() and (want_s[dead] == -1).all()
        if pcap == 3:
            assert (want_c > 3).any()  # some groups overflow pcap


@pytest.mark.parametrize("em", ["ray", "group"])
@pytest.mark.parametrize("g", [1, 128])
def test_emission_stats_match_reference(wave, g, em):
    """Pairs and pcap drops (the sums of each group's capped and overflowing
    raw count) against the JAX reference's pipeline in interpret mode."""
    _, sj = jbinned.pallas_closest_binned(
        wave["jfat"], wave["packed"], jnp.asarray(wave["o"]), jnp.asarray(wave["d"]),
        t_max=jnp.asarray(wave["t_max"]), g=g, pcap=4, em=em, mcap=MCAP, interpret=True,
        slot_payload=True, with_stats=True,
    )
    bins = binned.bin_pairs(wave["fat"], *(torch.from_numpy(wave[k]) for k in ("o", "d", "t_max")),
                            g=g, pcap=4, mcap=MCAP, em=em)
    assert bins.stats == {k: int(v) for k, v in sj.items()}
    assert bins.stats["pairs"] > 100


@pytest.mark.parametrize("mcap", [MCAP, 200])
@pytest.mark.parametrize("sb", [1, 2])
@pytest.mark.parametrize("g", [8, 16])
def test_bins_layout_matches_a_python_loop(wave, g, sb, mcap):
    """Sort and padding: the pairs (group * pcap + p) in (leaf, pair id)
    order, cut to mcap, each leaf's run padded with -1 to whole steps of sb
    bins; ``lost`` marks the lanes of every group that dropped a pair."""
    pcap = 4
    fat = wave["fat"]
    rays = [torch.from_numpy(wave[k]) for k in ("o", "d", "t_max")]
    bins = binned.bin_pairs(fat, *rays, g=g, pcap=pcap, mcap=mcap, sb=sb)
    count, slots = binned._emit(fat, *_padded(wave, g), block_trace.T_MIN, g, pcap, "ray")
    pairs = sorted((int(slots[grp, p]), grp * pcap + p)
                   for grp in range(count.numel()) for p in range(min(int(count[grp]), pcap)))
    lost = set(grp for grp in range(count.numel()) if count[grp] > pcap)
    lost |= set(pid // pcap for _, pid in pairs[mcap:])
    pw = sb * binned.LANES // g
    pair_id, bin_leaf = [], []
    for leaf in range(fat.num_leaves):
        run = [pid for lf, pid in pairs[:mcap] if lf == leaf]
        run += [-1] * (-len(run) % pw)
        pair_id += run
        bin_leaf += [leaf] * (len(run) // pw * sb)
    assert bins.pair_id.tolist() == pair_id and bins.bin_leaf.tolist() == bin_leaf
    want_lost = torch.zeros(count.numel(), dtype=torch.bool)
    want_lost[sorted(lost)] = True
    assert torch.equal(bins.lost, want_lost.repeat_interleave(g)[:bins.n])
    assert bins.stats["bins_used"] * sb == len(bin_leaf) and len(lost) > 0
    assert (bins.stats["dropped_mcap"] > 0) == (mcap < MCAP)


def test_emission_kernel_refuses_cpu_tensors(wave):
    o, inv, tb = _padded(wave, 8)
    before = dict(binned.LAUNCHES)
    count, _ = binned.emit(wave["fat"], o, inv, tb, block_trace.T_MIN, 8, 16, "ray")
    assert int(count.sum()) > 0 and binned.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        binned.emit_launch(wave["fat"], o, inv, tb, block_trace.T_MIN, 8, 16, "ray")


def test_emission_past_the_budget_takes_tiles(monkeypatch):
    """The emission kernel holds every leaf box where they fit its shared
    memory and tiles of EMIT_TILE leaves past that (checked here with the
    budget made small); ``emit_mode="tiled"`` forces tiles of a multiple of
    32 leaves, at least FORCED_TILES of them; nothing is refused."""
    assert binned.emit_smem(759, 8, 16) == 24 * (759 + 24) + 4 * 16 * 16
    assert binned.emit_tile_leaves(759, 8, 16) == 759
    assert binned.emit_tile_leaves(12000, 8, 16) == binned.EMIT_TILE
    assert binned.emit_smem(binned.EMIT_TILE, 1, 128) <= binned.EMIT_SMEM_BUDGET
    for leaves, tile in ((759, 192), (13, 32), (12000, 2048)):
        assert binned.emit_tile_leaves(leaves, 8, 16, "tiled") == tile
    monkeypatch.setattr(binned, "EMIT_SMEM_BUDGET", binned.emit_smem(100, 8, 16))
    assert binned.emit_tile_leaves(100, 8, 16) == 100
    assert binned.emit_tile_leaves(101, 8, 16) == binned.EMIT_TILE
    assert binned.emit_tile_leaves(100, 4, 16) == binned.EMIT_TILE  # more slot rows
    with pytest.raises(ValueError, match="emit_mode"):
        binned.emit_tile_leaves(100, 8, 16, "leaf")
