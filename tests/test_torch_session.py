"""Port session layer: PointAccSession / MapContext / MappingCache policy,
against the reference where the reference defines the behaviour (kernel
size inference, LRU counters), and the one-sort-per-stride-level
invariant of the mapping."""

import numpy as np
import pytest
import torch

from repro.api import MappingCache as RefMappingCache
from repro.core.tensor import infer_kernel_size as ref_infer_kernel_size
from repro_torch.api import MappingCache, PointAccSession, SessionConfig
from repro_torch.core import mapping as TM
from repro_torch.core.tensor import infer_kernel_size
from repro_torch.data.synthetic import lidar_scene
from repro_torch.models import minkunet as TMU
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401


def test_infer_kernel_size_matches_reference():
    for k, nd in ((27, 3), (8, 3), (1, 3), (9, 2), (125, 3)):
        assert infer_kernel_size(k, nd) == ref_infer_kernel_size(k, nd)
    with pytest.raises(ValueError, match="perfect"):
        infer_kernel_size(26, 3)


def test_mapping_cache_lru_counters_match_reference():
    port, ref = MappingCache(max_entries=2), RefMappingCache(max_entries=2)
    arrays = [np.arange(i, i + 4, dtype=np.int32) for i in range(3)]
    for idx in (0, 1, 0, 2, 1, 1):
        got = port.get([arrays[idx]], lambda: idx, extra=("x", idx))
        want = ref.get([arrays[idx]], lambda: idx, extra=("x", idx))
        assert got == want
    assert port.stats() == ref.stats()
    assert len(port) == 2 and port.evictions == 2
    with pytest.raises(ValueError, match="max_entries"):
        MappingCache(0)


def test_session_policy_and_transposed_errors():
    with pytest.raises(ValueError, match="unknown flow"):
        SessionConfig(flow="pallas_fused")
    assert PointAccSession(engine="v1").config.engine == "v1"
    with pytest.raises(ValueError, match="unknown engine"):
        PointAccSession(engine="v3")
    coords, mask, feats = lidar_scene(1, 80, grid=10)
    session = PointAccSession(flow="cuda")
    x = session.tensor(torch.from_numpy(coords), torch.from_numpy(mask),
                       torch.from_numpy(feats))
    coarse = session.tensor(torch.from_numpy(coords), torch.from_numpy(mask),
                            torch.from_numpy(feats), stride=2)
    with pytest.raises(ValueError, match="no forward maps"):
        session.conv_transposed(coarse, torch.zeros(8, 4, 3), stride=2)
    with pytest.raises(ValueError, match="does not divide"):
        x.context.transposed_maps(2, 1, 2)
    h = session.conv(x, torch.ones(8, 4, 3), stride=2)
    assert h.stride == 2 and h.num_channels == 3
    maps_a, _ = x.context.conv_maps(2, 1, 2)
    maps_b, _ = x.context.conv_maps(2, 1, 2)
    assert maps_a is maps_b                      # memoized
    y = session.conv_transposed(h, torch.ones(8, 3, 5), stride=2)
    assert y.stride == 1 and y.feats.shape == (80, 5)
    assert bool((y.feats[~x.mask] == 0).all())   # no epilogue: rows masked
    capped = PointAccSession(flow="cuda_fused", cap=16)
    xc = capped.tensor(torch.from_numpy(coords), torch.from_numpy(mask),
                       torch.from_numpy(feats))
    hc = capped.conv(xc, torch.ones(8, 4, 3), stride=2)
    with pytest.warns(UserWarning, match="scatter-built inverse"):
        capped.conv_transposed(hc, torch.ones(8, 3, 5), stride=2)


def test_forward_sorts_once_per_stride_level(monkeypatch):
    """The paper's one-sort-per-level invariant: the cloud is ranked once
    (`sort_cloud`), each coarser level comes out of `downsample_sorted`
    already sorted, and the fused flow's canonicalisation reuses it."""
    calls = {"sort_cloud": 0, "downsample_sorted": 0}
    for name in calls:
        real = getattr(TM, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(TM, name, counted)
    module = TMU.mini_minkunet_init(torch.Generator().manual_seed(3))
    coords, mask, feats = lidar_scene(2, 120, grid=10)
    for flow in ("fod", "cuda_fused"):
        calls.update(sort_cloud=0, downsample_sorted=0)
        session = PointAccSession(flow=flow)
        x = session.tensor(torch.from_numpy(coords), torch.from_numpy(mask),
                           torch.from_numpy(feats))
        out = TMU.minkunet_forward(session, module, x)
        assert out.shape == (120, 13)
        assert calls == {"sort_cloud": 1, "downsample_sorted": 2}, flow
