"""What the kernels' wrappers size and keep on the host side, on the CPU:
the two norms' backward grids (:func:`rms_norm.backward_grid`,
:func:`layer_norm.backward_grid`: one wave of the clusters the card holds
at once) and the LayerNorm backward's scratch, the tickets a kernel keeps
zero on its device (:func:`repro_torch.kernels.tickets`), and the refusals
that come before any launch."""
import pytest
import torch

from repro_torch import kernels as KN
from repro_torch.kernels import layer_norm as lnk
from repro_torch.kernels import rms_norm as rn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("M", [1, 7, 8, 1024, 4099, 65536])
@pytest.mark.parametrize("clusters", [1, 7, 32, 64])
def test_rms_norm_backward_grid_is_one_wave_of_whole_clusters(M, clusters):
    blocks, rows = rn.backward_grid(M, 4096, clusters)
    assert blocks % rn.CLUSTER == 0 and blocks >= rn.CLUSTER
    assert blocks <= clusters * rn.CLUSTER            # every cluster at work at once
    assert blocks * rows >= M and rows >= 1
    assert (blocks - rn.CLUSTER) * rows < M           # no cluster past the first is empty
    assert rows == -(-M // (clusters * rn.CLUSTER))


def test_rms_norm_backward_grid_at_the_train_shape():
    assert rn.backward_grid(1024, 4096, 32) == (256, 4)
    assert rn.backward_grid(1024, 4096, 31) == (208, 5)
    assert rn.backward_grid(1, 768, 64) == (8, 1)


def test_tickets_are_made_zero_once_and_kept():
    KN._tickets.pop(("test_kernel", None), None)
    cpu = torch.device("cpu")
    t = KN.tickets(cpu, "test_kernel", 8)
    assert t.dtype == torch.int32 and t.shape == (8,) and not t.any()
    t[3] = 5          # a kernel would leave them zero; the array is the same object
    assert KN.tickets(cpu, "test_kernel", 4) is t
    with pytest.raises(ValueError, match="tickets"):
        KN.tickets(cpu, "test_kernel", 9)
    KN._tickets.pop(("test_kernel", None))


def test_rms_norm_backward_refuses_rows_wider_than_its_shared_memory():
    x = torch.zeros((2, rn.MAX_BACKWARD_D + 1))
    with pytest.raises(ValueError, match="rows of"):
        rn.rms_norm_backward_cuda(x, torch.ones(x.shape[1]), x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rn.rms_norm_backward_cuda(x[:, :8], torch.ones(8), x[:, :8])


@pytest.mark.parametrize("M", [1, 7, 8, 1024, 4099])
@pytest.mark.parametrize("clusters", [1, 7, 16, 32])
@pytest.mark.parametrize("d", [384, 768, 1024, 1025, 4096])
def test_layer_norm_backward_grid_is_one_wave_of_whole_clusters(M, clusters, d):
    blocks, rows = lnk.backward_grid(M, d, clusters)
    assert blocks % lnk.CLUSTER == 0 and blocks >= lnk.CLUSTER
    assert blocks <= clusters * lnk.CLUSTER           # every cluster at work at once
    assert blocks * rows >= M and rows >= 1
    assert (blocks - lnk.CLUSTER) * rows < M          # no cluster past the first is empty
    if d <= lnk.WARP_ROWS_D:                          # a warp a row: whole warps a block
        assert rows % lnk.WARPS == 0
        assert rows < -(-M // (clusters * lnk.CLUSTER)) + lnk.WARPS
    else:
        assert rows == -(-M // (clusters * lnk.CLUSTER))


@pytest.mark.parametrize("M", [1, 7, 8, 1024, 4099])
@pytest.mark.parametrize("d", [768, 4096])
def test_layer_norm_backward_scratch(M, d):
    """A cluster's partial of dscale and dbias (2 d floats) for each
    cluster of the grid, dscale and dbias together, and one ticket a block
    of a cluster."""
    clusters = 16
    blocks, _ = lnk.backward_grid(M, d, clusters)
    assert lnk.backward_scratch(M, d, clusters) == {
        "dparams": (2, d), "part": (blocks // lnk.CLUSTER, 2 * d),
        "tickets": (lnk.CLUSTER,)}


def test_layer_norm_backward_grid_at_the_train_shapes():
    # opt-125m's B*T rows of 768: a warp a row, one row a warp on 128 blocks
    assert lnk.backward_grid(1024, 768, 32) == (128, 8)
    assert lnk.backward_grid(1024, 768, 16) == (128, 8)
    assert lnk.backward_grid(1024, 768, 15) == (64, 16)
    assert lnk.backward_grid(1024, 4096, 32) == (256, 4)
    assert lnk.backward_grid(1, 768, 64) == (8, 8)
    assert lnk.backward_grid(1, 4096, 64) == (8, 1)


def test_layer_norm_backward_refuses_before_launching():
    x = torch.zeros((2, lnk.MAX_BACKWARD_D + 1))
    with pytest.raises(ValueError, match="rows of"):
        lnk.layer_norm_backward_cuda(x, torch.ones(x.shape[1]), x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lnk.layer_norm_backward_cuda(x[:, :8], torch.ones(8), x[:, :8])
    with pytest.raises(ValueError, match="come together"):
        lnk.layer_norm_backward_cuda(x[:, :8], torch.ones(8), x[:, :8], mean=torch.zeros(2))
