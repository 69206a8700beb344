"""The row gathers' backward (ops/raster_cuda.py gather_rows_bwd): the
kernel's plain-PyTorch preparation (the stable sort's permutation and each
table row's run start) against numpy on the shapes the renders give and on
the edge cases; a torch model of the kernel's per-row sum over those runs
bitwise against autograd's index backward; the CPU routing and the
argument checks. The kernel itself runs only on the card (chip_smoke.py
holds it against the library there).

All on the CPU with one intra-op thread (autograd's index backward adds
in position order only then), at a tiny size."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from activesplat_tpu_torch.ops import raster_cuda as rc
from test_torch_tracing import gather_case

N = 300  # the table's live rows; row N pads


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ids_case(kind):
    """(ids, n) for one case; the table has n + 1 rows."""
    g = torch.Generator().manual_seed(5)
    if kind in ("capped", "csr"):
        data, ids = gather_case(kind)
        return ids, data.shape[0]
    if kind == "no padding":
        return torch.randint(0, N, (32, 64), generator=g), N
    if kind == "all padding":
        return torch.full((16, 64), N), N
    if kind == "empty":
        return torch.zeros((0,), dtype=torch.int64), N
    if kind == "one id 1024 times":
        ids = torch.full((1024, 1), 7)
        return torch.cat([ids, torch.full((1024, 1), N)], 1), N
    if kind == "rows 0 and N-1":
        ids = torch.tensor([N - 1, 0, N, 0, N - 1, N - 1, N, 0], dtype=torch.int32)
        return ids, N
    raise ValueError(kind)


CASES = ("capped", "csr", "no padding", "all padding", "empty", "one id 1024 times",
         "rows 0 and N-1")


def kernel_model(grad, ids, n_rows):
    """gather_rows_bwd_kernel in torch: each row below the last sums its
    run's gradient rows in sorted (position) order from zero, all rows a
    step at a time; the last row stays zero and its run is never read."""
    width = grad.shape[-1]
    rows = grad.reshape(-1, width)
    perm, starts = rc.gather_bwd_runs(ids, n_rows)
    lo, hi = starts[:-1].long(), starts[1:].long()
    out = torch.zeros((n_rows, width), dtype=grad.dtype)
    for i in range(int((hi - lo).max()) if n_rows > 1 else 0):
        j = lo + i
        live = j < hi
        out[:-1][live] += rows[perm[j[live]]]
    return out


@pytest.mark.parametrize("kind", CASES)
def test_runs_hold_each_rows_positions_in_order(kind):
    ids, n = ids_case(kind)
    perm, starts = rc.gather_bwd_runs(ids, n + 1)
    assert perm.dtype == torch.int64 and perm.shape == (ids.numel(),)
    assert starts.dtype == torch.int32 and starts.shape == (n + 1,)
    flat = ids.reshape(-1).numpy()
    perm, starts = perm.numpy(), starts.numpy()
    ends = np.append(starts[1:], flat.size)
    for g in range(n + 1):
        np.testing.assert_array_equal(perm[starts[g]:ends[g]], np.flatnonzero(flat == g))


@pytest.mark.parametrize("kind", CASES)
def test_kernel_model_matches_index_backward_bitwise(kind):
    ids, n = ids_case(kind)
    grad = torch.randn(ids.shape + (16,), generator=torch.Generator().manual_seed(3))[..., :11]
    want = torch.ops.aten._index_put_impl_(grad.new_zeros((n + 1, 11)), [ids.long()], grad,
                                           True, True)
    got = kernel_model(grad, ids, n + 1)
    assert torch.equal(got[:n], want[:n])
    assert not got[n].any()


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ("capped", "csr"))
def test_cpu_tensor_takes_index_backward_and_launches_nothing(kind):
    ids, n = ids_case(kind)
    grad = torch.randn(ids.shape + (11,), generator=torch.Generator().manual_seed(4))
    rc.reset_launch_counts()
    with OpLog() as ops:
        got = rc.gather_rows_bwd(grad, ids, n + 1)
    assert ops.ops == ["aten.new_zeros", "aten._index_put_impl_"]
    want = torch.ops.aten._index_put_impl_(grad.new_zeros((n + 1, 11)), [ids], grad, True, True)
    assert torch.equal(got, want)
    assert rc.gather_rows_bwd.launches == 0


def test_reset_launch_counts_clears_the_gather_backward():
    rc.gather_rows_bwd.launches = 3
    rc.reset_launch_counts()
    assert rc.gather_rows_bwd.launches == 0


@pytest.mark.parametrize(
    "bad",
    [
        lambda g, i, n: (g, i.float(), n),  # float ids
        lambda g, i, n: (g[:-1], i, n),  # grad not ids' shape
        lambda g, i, n: (g[..., 0], i, n),  # grad without a width
        lambda g, i, n: (g[..., :0], i, n),  # a width of zero
        lambda g, i, n: (g, i, 0),  # no table row
        lambda g, i, n: (g, i, 2**31),  # more rows than int32 keys hold
        lambda g, i, n: (g.to("meta"), i.to("meta"), n),  # neither the card nor the CPU
        lambda g, i, n: (g.to("meta"), i, n),  # ids on another device
    ],
)
def test_gather_backward_rejects_bad_arguments(bad):
    ids, n = ids_case("csr")
    grad = torch.randn(ids.shape + (11,))
    with pytest.raises(ValueError):
        rc.gather_rows_bwd(*bad(grad, ids, n + 1))
