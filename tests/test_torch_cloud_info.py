"""The port's data-model constructors take their device from the caller:
`RawScan.from_numpy` and `DeskewInfo.empty` have no default device."""

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
    DeskewInfo, RawScan)


def _scan_arrays(n=5):
    r = np.random.RandomState(0)
    return (r.uniform(-10, 10, (n, 3)), np.ones(n), r.randint(0, 16, n),
            np.zeros(n))


def test_constructors_need_a_device():
    with pytest.raises(TypeError):
        RawScan.from_numpy(*_scan_arrays(), max_points=8)
    with pytest.raises(TypeError):
        DeskewInfo.empty(3)
    with pytest.raises(TypeError):                 # keyword only
        DeskewInfo.empty(3, torch.device("cpu"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_constructors_place_tensors_on_the_given_device(device):
    dev = torch.device(device)
    raw = RawScan.from_numpy(*_scan_arrays(), max_points=8, device=dev)
    info = DeskewInfo.empty(3, device=dev)
    for t in (*raw, *info):
        assert t.device == dev
    assert raw.xyz.shape == (8, 3) and raw.valid.shape == (8,)
    assert raw.xyz.dtype == torch.float32 and raw.ring.dtype == torch.int32
    assert info.initial_guess.shape == (3, 6)
    if device == "cpu":
        assert raw.valid.tolist() == [True] * 5 + [False] * 3
