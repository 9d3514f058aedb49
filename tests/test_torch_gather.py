"""Port gather: the plain version of the gather kernel against the
reference's Pallas gather_channels in interpret mode. A gather copies
values, so the comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gltf_renderer_tpu.ops.pallas_gather import gather_channels as ref_gather
from vk_gltf_renderer_tpu_torch.ops import gather as tgather


@pytest.mark.parametrize("channels,n", [(2, 3000), (4, 1024), (4, 5)])
def test_plain_gather_matches_pallas_interpret(channels, n):
    rng = np.random.default_rng(channels * 1000 + n)
    tab = rng.normal(size=(channels, 64 * 128)).astype(np.float32)
    idx = rng.integers(0, tab.shape[1], size=n).astype(np.int32)
    idx[:2] = [0, tab.shape[1] - 1]
    ref = np.asarray(ref_gather(jnp.asarray(tab), jnp.asarray(idx), interpret=True))
    port = tgather.gather_channels(torch.tensor(tab), torch.tensor(idx)).numpy()
    assert port.shape == (channels, n)
    assert np.array_equal(port, ref)


def test_gather_on_a_row_slice_of_the_sampling_table():
    """The HDR path gathers from row slices samp[0:2] / samp[2:6]."""
    samp = torch.arange(6 * 16, dtype=torch.float32).reshape(6, 16)
    idx = torch.tensor([3, 0, 15], dtype=torch.int32)
    out = tgather.gather_channels(samp[2:6], idx)
    assert torch.equal(out, samp[2:6][:, idx.long()])


def test_gather_refuses_other_devices():
    with pytest.raises(ValueError):
        tgather.gather_channels(torch.zeros((2, 8), device="meta"), torch.zeros(4, dtype=torch.int32))
