"""Port serving engine: `PointCloudEngine(device="cpu").segment` against
the reference engine on a mini-MinkUNet scene through a small ladder, the
mapping cache, the device policy (no quiet CPU fallback), and the engine
policy (v1 accepted, an unknown engine refused)."""

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import lidar_scene
from repro.models import minkunet as MU
from repro.serve.buckets import geometric_ladder
from repro.serve.engine import PointCloudEngine
from repro_torch.api import PointAccSession
from repro_torch.kernels.spconv import spconv as TK
from repro_torch.models import minkunet as TMU
from repro_torch.serve import buckets as TBK
from repro_torch.serve.engine import PointCloudEngine as TEngine
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def mini():
    params = jax.jit(MU.mini_minkunet_init)(jax.random.key(0))
    module = TMU.load_jax_params(
        TMU.mini_minkunet_init(torch.Generator().manual_seed(0)),
        jax.tree_util.tree_map(np.asarray, params))
    return params, module


def test_segment_matches_reference_engine_and_hits_cache(mini):
    params, module = mini
    coords, mask, feats = lidar_scene(5, 200, grid=16)
    ref = PointCloudEngine(params, n_stages=2, flow="fod",
                           ladder=geometric_ladder(64, 512))
    port = TEngine(module, n_stages=2, device="cpu",
                   ladder=TBK.geometric_ladder(64, 512))
    assert port.flow == "cuda_fused"
    assert port.scene_key(coords, mask, 256) == ref.scene_key(coords, mask,
                                                               256)
    want, want_hit = ref.segment(coords, mask, feats)
    TK.reset_launch_counts()
    for call in range(2):
        got, hit = port.segment(coords, mask, feats)
        assert hit is (call == 1)
        assert got.device.type == "cpu" and got.shape == (200,)
        np.testing.assert_array_equal(got.numpy()[mask],
                                      np.asarray(want)[mask])
    assert want_hit is False
    assert port.cache_stats()["hits"] == 1
    assert port.cache_stats()["misses"] == 1
    assert not any(TK.LAUNCHES.values())
    levels, hit = port.levels_for(coords, mask)
    assert hit and len(levels) == 3
    got, hit = port.segment(coords, mask, feats, levels=levels)
    assert hit is None
    np.testing.assert_array_equal(got.numpy()[mask], np.asarray(want)[mask])


def test_segment_labels_are_int32_like_reference(mini):
    params, module = mini
    coords, mask, feats = lidar_scene(6, 150, grid=16)
    ref = PointCloudEngine(params, n_stages=2, flow="fod",
                           ladder=geometric_ladder(64, 512))
    port = TEngine(module, n_stages=2, device="cpu",
                   ladder=TBK.geometric_ladder(64, 512))
    want, _ = ref.segment(coords, mask, feats)
    got, _ = port.segment(coords, mask, feats)
    want = np.asarray(want)
    assert want.dtype == np.int32 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])


def test_device_policy_and_unported_entry_points(mini):
    _, module = mini
    if torch.cuda.is_available():
        assert TEngine(module, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TEngine(module, 2)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TEngine(module, 2, device="cuda")
    eng = TEngine.factory(module, 2, device="cpu", flow="fod")()
    assert eng.device.type == "cpu" and eng.flow == "fod"
    coords, mask, feats = lidar_scene(6, 100, grid=10)
    assert TEngine(module, 2, device="cpu",
                   engine="v1").session.config.engine == "v1"
    with pytest.raises(ValueError, match="unknown engine"):
        TEngine(module, 2, device="cpu", engine="v3")
    # the batched surface runs on the CPU
    preds, hit = eng.segment_batch(coords[None], mask[None], feats[None])
    assert preds.shape == (1, 100) and hit is False
    want, _ = eng.segment(coords, mask, feats)
    np.testing.assert_array_equal(preds[0].numpy(), want.numpy())
    assert eng.scheduler() is eng.scheduler()
    levels, hit = eng.levels_for(coords[None], mask[None], batched=True)
    assert len(levels) == 1 and hit
    assert eng.compile_stats() == {"build": 1, "apply": 1, "apply_batch": 1}


def test_bucket_padding_keeps_valid_rows_and_precision_is_f32(mini):
    """The ladder's invariant: sentinel padding (`pad_scene`,
    `SparseTensor.padded_to`) leaves valid-row logits unchanged."""
    _, module = mini
    eng = TEngine(module, 2, device="cpu", flow="cuda_fused")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    coords, mask, feats = lidar_scene(7, 90, grid=10)
    session = PointAccSession(flow="cuda_fused")
    x = session.tensor(torch.from_numpy(coords), torch.from_numpy(mask),
                       torch.from_numpy(feats))
    want = TMU.minkunet_forward(session, module, x)
    got = TMU.minkunet_forward(session, module, x.padded_to(128))
    assert x.padded_to(90) is x
    with pytest.raises(ValueError, match="only grow"):
        x.padded_to(64)
    np.testing.assert_allclose(got[:90].numpy()[mask], want.numpy()[mask],
                               rtol=1e-5, atol=1e-5)
    preds, _ = eng.segment(coords, mask, feats)   # pads 90 -> 128 rows
    np.testing.assert_array_equal(preds.numpy()[mask],
                                  want.argmax(-1).numpy()[mask])
