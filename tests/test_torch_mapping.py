"""Port parity, integers: packed keys, the v2 mapping engine, inverse
tables, bucket padding, digests and synthetic scenes.

Every comparison here is exact: the port must reproduce the reference's
integer outputs bit for bit (same inputs, made with numpy from a seed).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as M
from repro.core import packed as PK
from repro.data import synthetic as S
from repro.kernels.spconv import ops as spops
from repro.serve import buckets as BK
from repro.core.tensor import geometry_digest
from repro_torch.core import mapping as TM
from repro_torch.core import packed as TPK
from repro_torch.core.tensor import geometry_digest as t_geometry_digest
from repro_torch.data import synthetic as TS
from repro_torch.kernels.spconv import ops as tspops
from repro_torch.serve import buckets as TBK
from tests.test_mapping import random_cloud

REPO = Path(__file__).resolve().parents[1]


def composed(hi, lo) -> np.ndarray:
    """Reference (hi int32, lo uint32) word pair -> the port's int64 key."""
    return (np.asarray(hi).astype(np.int64) << 32) \
        | np.asarray(lo).astype(np.uint32).astype(np.int64)


def both_clouds(coords, mask, stride=1):
    ref = M.make_point_cloud(jnp.asarray(coords), jnp.asarray(mask), stride)
    port = TM.make_point_cloud(torch.from_numpy(coords),
                               torch.from_numpy(mask), stride)
    return ref, port


def edge_coords(rng, n=600):
    """In-budget, out-of-budget (batch and spatial) and masked rows."""
    coords = np.stack([
        rng.integers(-2, PK.BATCH_MAX + 3, n),
        rng.integers(PK.COORD_MIN - 3, PK.COORD_MAX + 4, n),
        rng.integers(PK.COORD_MIN - 3, PK.COORD_MAX + 4, n),
        rng.integers(PK.COORD_MIN - 3, PK.COORD_MAX + 4, n),
    ], axis=1).astype(np.int32)
    coords[: n // 3, 1:] = rng.integers(-40, 40, size=(n // 3, 3))
    coords[n // 3: n // 2] = [[PK.BATCH_MAX, PK.COORD_MAX, PK.COORD_MIN, 0]]
    mask = rng.random(n) > 0.2
    return coords, mask


def test_packed_keys_and_sentinels_match_reference():
    rng = np.random.default_rng(0)
    coords, mask = edge_coords(rng)
    hi, lo = PK.pack_coords(jnp.asarray(coords), jnp.asarray(mask))
    key = TPK.pack_coords(torch.from_numpy(coords), torch.from_numpy(mask))
    np.testing.assert_array_equal(key.numpy(), composed(hi, lo))
    assert TPK.KEY_SENTINEL == int(composed(PK.KEY_HI_SENTINEL,
                                            PK.KEY_LO_SENTINEL))
    assert TPK.KEY_SENTINEL == torch.iinfo(torch.int64).max
    t_hi, t_lo = TPK.key_words(key)
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(lo).astype(np.int64))
    valid = ~TPK.is_sentinel_key(key)
    assert bool((key[valid] < 2**62).all())
    np.testing.assert_array_equal(TPK.unpack_keys(key).numpy(),
                                  np.asarray(PK.unpack_keys(hi, lo)))
    for stride in (2, 8, 1024):
        qhi, qlo = PK.quantize_keys(hi, lo, stride)
        np.testing.assert_array_equal(
            TPK.quantize_keys(key, stride).numpy(), composed(qhi, qlo))


def test_searchsorted_matches_reference_pair_search():
    rng = np.random.default_rng(1)
    coords, mask = edge_coords(rng, 300)
    key = TPK.pack_coords(torch.from_numpy(coords), torch.from_numpy(mask))
    s, _ = torch.sort(key)
    base = key[torch.from_numpy(rng.permutation(300)[:120])]
    delta = torch.from_numpy(rng.integers(-1, 2, size=120))
    q = torch.where(TPK.is_sentinel_key(base), base, base + delta)
    q = q.clamp(min=0).reshape(4, 30)      # hits, gaps and sentinels
    s_hi, s_lo = TPK.key_words(s)
    q_hi, q_lo = TPK.key_words(q)
    pos = PK.searchsorted_pair(jnp.asarray(s_hi.numpy()),
                               jnp.asarray(s_lo.numpy().astype(np.uint32)),
                               jnp.asarray(q_hi.numpy()),
                               jnp.asarray(q_lo.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(TPK.searchsorted(s, q).numpy(),
                                  np.asarray(pos))


def ref_pyramid(coords, mask, n_levels=3):
    """The reference's sort -> (subm maps, down maps, downsample) chain for
    `n_levels` stride levels, under one jit."""
    def chain(c, m):
        sc = M.sort_cloud(M.PointCloud(c, m, 1))
        out = []
        for _ in range(n_levels):
            subm, _ = M.build_conv_maps_cached(sc, 3, 1)
            down, nxt = M.build_conv_maps_cached(sc, 2, 2)
            out.append({"sc": sc, "subm": subm, "down": down})
            sc = nxt
        return out
    return jax.jit(chain)(jnp.asarray(coords), jnp.asarray(mask))


@pytest.mark.parametrize("n_valid,cap", [(120, 160), (300, 300)])
def test_sort_downsample_and_maps_match_reference(n_valid, cap):
    rng = np.random.default_rng(n_valid)
    coords, mask = random_cloud(rng, n_valid, cap, grid=12)
    _, port_pc = both_clouds(coords, mask)
    tsc = TM.sort_cloud(port_pc)
    for lv in ref_pyramid(coords, mask):
        rsc = lv["sc"]
        np.testing.assert_array_equal(tsc.perm.numpy(), np.asarray(rsc.perm))
        np.testing.assert_array_equal(tsc.sorted_keys.numpy(),
                                      composed(rsc.sorted_hi, rsc.sorted_lo))
        np.testing.assert_array_equal(tsc.pc.coords.numpy(),
                                      np.asarray(rsc.pc.coords))
        np.testing.assert_array_equal(tsc.pc.mask.numpy(),
                                      np.asarray(rsc.pc.mask))
        for ks, stride in ((3, 1), (2, 2)):
            rmaps = lv["subm" if stride == 1 else "down"]
            tmaps, tout = TM.build_conv_maps_cached(tsc, ks, stride)
            np.testing.assert_array_equal(tmaps.inv.numpy(),
                                          np.asarray(rmaps.inv))
            assert tmaps.inv.dtype == torch.int32
            for f in ("in_idx", "out_idx", "valid", "offsets"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(tmaps, f)),
                    np.asarray(getattr(rmaps, f)))
            if stride == 2:
                np.testing.assert_array_equal(tmaps.inv_t.numpy(),
                                              np.asarray(rmaps.inv_t))
                np.testing.assert_array_equal(tmaps.swap().inv.numpy(),
                                              np.asarray(rmaps.swap().inv))
        tsc = tout


def test_match_table_and_capped_maps_match_reference():
    rng = np.random.default_rng(5)
    coords, mask = random_cloud(rng, 90, 128, grid=9)
    _, port_pc = both_clouds(coords, mask)
    tsc = TM.sort_cloud(port_pc)
    offs = TM.kernel_offsets(3, 3, 1)[::4] * 2

    @jax.jit
    def ref(c, m):
        pc = M.PointCloud(c, m, 1)
        sc = M.sort_cloud(pc)
        return (M.match_table(sc, pc, offs), M.kernel_map_v2(sc, pc, 3, 40),
                M.kernel_map_v2(sc, pc, 3, 200))

    table, *capped = ref(jnp.asarray(coords), jnp.asarray(mask))
    np.testing.assert_array_equal(TM.match_table(tsc, port_pc, offs).numpy(),
                                  np.asarray(table))
    for cap, rmaps in zip((40, 200), capped):  # truncating, then padding
        tmaps = TM.kernel_map_v2(tsc, port_pc, 3, cap=cap)
        for f in ("in_idx", "out_idx", "valid"):
            np.testing.assert_array_equal(getattr(tmaps, f).numpy(),
                                          np.asarray(getattr(rmaps, f)))
        assert (tmaps.inv is None) == (rmaps.inv is None)
        # the scatter branch of invert_maps
        np.testing.assert_array_equal(
            tspops.invert_maps(tmaps, 128).numpy(),
            np.asarray(spops.invert_maps(rmaps, 128)))
    with pytest.raises(ValueError, match="inv_t is None"):
        TM.kernel_map_v2(tsc, port_pc, 3, cap=40).swap(require_inverse=True)


def test_out_of_budget_raises_and_v1_is_not_ported():
    coords = np.array([[0, 1, 2, 3], [0, 40000, 0, 0]], np.int32)
    _, port_pc = both_clouds(coords, np.ones(2, bool))
    with pytest.raises(ValueError, match="outside the packed-key budget"):
        TM.sort_cloud(port_pc)
    maps, _ = TM.build_conv_maps(port_pc, 3, 1, engine="v1")
    assert int(maps.valid.sum()) == 2            # each point with itself


def test_pad_scene_digest_and_ladder_match_reference():
    coords, mask, feats = S.lidar_scene(4, 300, grid=16)
    mask[::7] = False
    for cap in (300, 512):
        for got, want in zip(TBK.pad_scene(coords, mask, feats, cap),
                             BK.pad_scene(coords, mask, feats, cap)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    assert TBK.DEFAULT_LADDER.capacities == BK.DEFAULT_LADDER.capacities
    lad = TBK.geometric_ladder(64, 1000, growth=1.5)
    assert lad.capacities == BK.geometric_ladder(64, 1000, 1.5).capacities
    assert TBK.resolve_max_batch({64: 2, "default": 3}, lad) == \
        BK.resolve_max_batch({64: 2, "default": 3},
                             BK.BucketLadder(lad.capacities))
    c, m, _ = BK.pad_scene(coords, mask, None, 512)
    for extra in (None, ("levels", 512)):
        assert t_geometry_digest((c, m), extra) == geometry_digest((c, m),
                                                                   extra)
    assert t_geometry_digest((torch.from_numpy(c), torch.from_numpy(m))) \
        == geometry_digest((c, m))


@pytest.mark.parametrize("kind", ["lidar", "city"])
def test_synthetic_scenes_match_reference(kind):
    if kind == "lidar":
        got, want = TS.lidar_scene(3, 500, grid=20), S.lidar_scene(3, 500,
                                                                 grid=20)
    else:
        got, want = TS.city_scene(7, 3000), S.city_scene(7, 3000)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # the multi-rank test processes run the port without jax too
    files.append(REPO / "tests" / "torch_dist.py")
    assert len(files) > 10
    names = {str(p.relative_to(REPO / "src" / "repro_torch"))
             for p in files if "repro_torch" in str(p)}
    assert {"distributed/sharding.py", "distributed/pipeline.py",
            "distributed/compression.py", "checkpoint/elastic.py",
            "launch/mesh.py", "compat.py", "costmode.py",
            "launch/dryrun.py", "launch/roofline.py"} <= names
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
