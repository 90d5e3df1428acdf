"""What the kernels' wrappers size and keep on the host side, on the CPU:
the RMSNorm backward's grid (:func:`rms_norm.backward_grid`: one wave of
the clusters the card holds at once), the tickets a
kernel keeps zero on its device (:func:`repro_torch.kernels.tickets`), and
the refusals that come before any launch."""
import pytest
import torch

from repro_torch import kernels as KN
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
