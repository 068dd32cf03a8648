"""K7, the table lookup, in the PyTorch port; and the default device of the
region-growing entries.

* The plain versions ``table_lookup_plain`` and ``sign_lookup_plain``
  equal the JAX package exactly (tolerance 0) through three routes: its
  CPU gather ``ops.histogram.table_lookup``, its packed-sign-word
  ``sign_lookup``, and the Pallas kernel ``_lookup_kernel`` in interpret
  mode with ``_table_lookup_pallas_x32``'s BlockSpecs.  The interpret
  kernel sums a one-hot selection, so it returns +0.0 for a -0.0 entry
  (equal as numbers), and JAX refuses its zero-step grid, so it has no
  N = 0 case.  Tables hold NaN, +-0.0 and +-inf.
* The wrappers take the plain versions for CPU tensors, count no launch
  there, and reject bad arguments.
* Tests marked ``gpu`` hold the CUDA kernel to its plain version exactly
  (tails, a ``storage_offset`` 1 view, a table too big for shared
  memory); they skip without a CUDA device.  JAX is imported only by the
  ``jref`` fixture, so on a machine with a card and no JAX they run with

      python -m pytest --noconftest -p no:cacheprovider \\
          tests/test_torch_lookup.py

* Host arrays with no ``device`` go to the card: without one, the
  region-growing entries raise from torch instead of running on the CPU.
"""

import functools
import types

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops import histogram as thist
from arterynetwork_tpu_torch.ops import lookup_kernels as lk
from arterynetwork_tpu_torch.ops.region_grow import (reconstruct_value_map,
                                                     region_grow,
                                                     region_grow_value_map)
from arterynetwork_tpu_torch.ops.region_grow_frontier import \
    region_grow_frontier
from arterynetwork_tpu_torch.ops.region_grow_fused import region_grow_fused
from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

torch.set_num_threads(1)

N_CASES = [0, 1, 15, 17, 70_000]
BIN_DTYPES = [np.uint8, np.int32]
TABLE_DTYPES = [np.float32, np.float64]
SPECIALS = [np.nan, -0.0, 0.0, np.inf, -np.inf]


@pytest.fixture(scope="module")
def jref():
    """The JAX package's lookups: the CPU gather, the packed sign words
    and the Pallas kernel in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from arterynetwork_tpu.ops import pallas_kernels as pk
    from arterynetwork_tpu.ops.histogram import sign_lookup, table_lookup

    def interpret(idx_flat, table):
        """``_table_lookup_pallas_x32`` with ``interpret=True``."""
        N, B = idx_flat.shape[0], table.shape[0]
        chunk = pk._ROWS_PER_STEP * pk.LANE
        idx = jnp.pad(idx_flat.astype(jnp.int32), (0, (-N) % chunk),
                      constant_values=-1)
        rows = idx.shape[0] // pk.LANE
        spec = pl.BlockSpec((pk._ROWS_PER_STEP, pk.LANE), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)
        out = pl.pallas_call(
            functools.partial(pk._lookup_kernel, B),
            grid=(rows // pk._ROWS_PER_STEP,),
            in_specs=[spec, pl.BlockSpec((B, 1), lambda i: (0, 0),
                                         memory_space=pltpu.VMEM)],
            out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((rows, pk.LANE), table.dtype),
            interpret=True,
        )(idx.reshape(rows, pk.LANE), table.reshape(B, 1))
        return out.reshape(-1)[:N]

    def run(fn, bins, table):
        with jax.enable_x64(True):
            return np.asarray(fn(jnp.asarray(bins), jnp.asarray(table)))

    return types.SimpleNamespace(
        gather=functools.partial(run, table_lookup),
        sign=functools.partial(run, sign_lookup),
        interpret=functools.partial(run, interpret))


def _case(n, bin_dtype, table_dtype, seed=0):
    """Bins in range (256 of them for uint8, 700 for int32) and a table
    whose first entries are NaN, -0.0, +0.0, +inf and -inf, each hit."""
    rng = np.random.default_rng(seed + n)
    num_bins = 256 if bin_dtype == np.uint8 else 700
    table = rng.normal(0, 1, num_bins).astype(table_dtype)
    table[:len(SPECIALS)] = SPECIALS
    bins = rng.integers(0, num_bins, n).astype(bin_dtype)
    bins[:len(SPECIALS)] = np.arange(len(SPECIALS))[:n]
    return bins, table


def _bits(a):
    """The bit pattern of a float array (NaN, -0.0 compared exactly)."""
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


# ----------------------------------------------------------------------
# plain versions against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("bin_dtype", BIN_DTYPES)
@pytest.mark.parametrize("n", N_CASES)
def test_values_match_jax_gather(jref, n, bin_dtype, table_dtype):
    bins, table = _case(n, bin_dtype, table_dtype)
    ref = jref.gather(bins, table)
    out = lk.table_lookup_plain(torch.from_numpy(bins),
                                torch.from_numpy(table)).numpy()
    assert out.dtype == ref.dtype == table_dtype and out.shape == (n,)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("bin_dtype", BIN_DTYPES)
@pytest.mark.parametrize("n", N_CASES)
def test_signs_match_jax_packed_words(jref, n, bin_dtype, table_dtype):
    bins, table = _case(n, bin_dtype, table_dtype)
    ref = jref.sign(bins, table)
    out = lk.sign_lookup_plain(torch.from_numpy(bins),
                               torch.from_numpy(table)).numpy()
    assert out.dtype == ref.dtype == np.bool_
    np.testing.assert_array_equal(out, ref)
    if n >= len(SPECIALS):      # NaN False, -0.0 / +0.0 / +inf True
        np.testing.assert_array_equal(out[:5], [False, True, True, True,
                                                False])


@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("bin_dtype", BIN_DTYPES)
@pytest.mark.parametrize("n", N_CASES[1:])
def test_plain_matches_interpret_kernel(jref, n, bin_dtype, table_dtype):
    bins, table = _case(n, bin_dtype, table_dtype)
    ref = jref.interpret(bins, table)
    tb, tt = torch.from_numpy(bins), torch.from_numpy(table)
    out = lk.table_lookup_plain(tb, tt).numpy()
    assert ref.dtype == table_dtype
    np.testing.assert_array_equal(out, ref)     # NaN == NaN, -0.0 == 0.0
    np.testing.assert_array_equal(lk.sign_lookup_plain(tb, tt).numpy(),
                                  ref >= 0)


# ----------------------------------------------------------------------
# the wrappers on the CPU
# ----------------------------------------------------------------------
def test_histogram_lookups_route_to_the_kernel_wrappers():
    assert thist.table_lookup is lk.table_lookup
    assert thist.sign_lookup is lk.sign_lookup


@pytest.mark.parametrize("shape", [(70_000,), (7, 9, 13)])
def test_cpu_takes_plain_and_counts_no_launch(shape):
    bins, table = _case(int(np.prod(shape)), np.uint8, np.float32)
    tb = torch.from_numpy(bins).reshape(shape)
    tt = torch.from_numpy(table)
    n0 = (lk.table_lookup.launches, lk.sign_lookup.launches)
    values, signs = lk.table_lookup(tb, tt), lk.sign_lookup(tb, tt)
    assert (lk.table_lookup.launches, lk.sign_lookup.launches) == n0
    assert values.shape == signs.shape == shape
    assert torch.equal(values.isnan(), lk.table_lookup_plain(tb, tt).isnan())
    assert torch.equal(signs, lk.sign_lookup_plain(tb, tt))


@pytest.mark.parametrize("case", ["float_bins", "int64_bins", "table_2d",
                                  "empty_table", "int_table",
                                  "mixed_devices", "strided_bins",
                                  "strided_table"])
@pytest.mark.parametrize("fn", ["table_lookup", "sign_lookup"])
def test_wrappers_reject_bad_arguments(fn, case):
    bins = torch.zeros(32, dtype=torch.uint8)
    table = torch.ones(256)
    args = {
        "float_bins": (bins.float(), table),
        "int64_bins": (bins.long(), table),
        "table_2d": (bins, table.reshape(16, 16)),
        "empty_table": (bins, table[:0]),
        "int_table": (bins, table.int()),
        "mixed_devices": (bins, torch.empty(256, device="meta")),
        "strided_bins": (bins[::2], table),
        "strided_table": (bins, table[::2]),
    }[case]
    with pytest.raises(ValueError):
        getattr(lk, fn)(*args)


# ----------------------------------------------------------------------
# the kernel on a CUDA device
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_same_bytes(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint8),
                                  ref.cpu().numpy().view(np.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("bin_dtype", BIN_DTYPES)
@pytest.mark.parametrize("n", [1, 15, 17, 4099, 200_000,
                               # a block's step is 256 threads x 4
                               # groups: 2,048 voxels in f64, 4,096 in
                               # f32 and in sign mode (one group of 16)
                               2047, 2048, 2049, 4095, 4096, 4097,
                               # many steps plus a tail of each size
                               4096 * 300 + 5, 9_000_011])
def test_kernel_matches_plain(cuda, n, bin_dtype, table_dtype, sign):
    bins, table = _case(n, bin_dtype, table_dtype)
    tb, tt = torch.from_numpy(bins).to(cuda), torch.from_numpy(table).to(cuda)
    fn = lk.sign_lookup if sign else lk.table_lookup
    plain = lk.sign_lookup_plain if sign else lk.table_lookup_plain
    n0 = fn.launches
    out = fn(tb, tt)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    _assert_same_bytes(out, plain(tb, tt))


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
def test_kernel_unaligned_view_and_big_table(cuda, sign):
    """A view at storage offset 1 (the scalar path), and an f64 table of
    20,000 entries (values do not fit 48 KB of shared memory)."""
    fn = lk.sign_lookup if sign else lk.table_lookup
    plain = lk.sign_lookup_plain if sign else lk.table_lookup_plain
    bins, table = _case(100_001, np.uint8, np.float32)
    tb = torch.from_numpy(bins).to(cuda)[1:]
    assert tb.storage_offset() == 1 and tb.is_contiguous()
    tt = torch.from_numpy(table).to(cuda)
    _assert_same_bytes(fn(tb, tt), plain(tb, tt))
    rng = np.random.default_rng(9)
    big = torch.from_numpy(rng.normal(0, 1, 20_000)).to(cuda)
    ib = torch.from_numpy(rng.integers(0, 20_000, 70_001).astype(
        np.int32)).to(cuda)
    _assert_same_bytes(fn(ib, big), plain(ib, big))
    _assert_same_bytes(fn(ib[1:], big), plain(ib[1:], big))


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("bins_kind", ["uniform", "skewed"])
def test_kernel_uniform_and_skewed_bins(cuda, bins_kind, table_dtype, sign):
    """A (64, 512, 170) volume of uint8 bins: every bin equally often
    (shared-memory bank conflicts) or 94% of the voxels in one bin (the
    tube's background: broadcasts)."""
    rng = np.random.default_rng(3)
    shape = (64, 512, 170)
    bins = rng.integers(0, 256, shape).astype(np.uint8)
    if bins_kind == "skewed":
        bins[rng.random(shape) < 0.94] = 17
    table = rng.normal(0, 1, 256).astype(table_dtype)
    table[:len(SPECIALS)] = SPECIALS
    tb, tt = torch.from_numpy(bins).to(cuda), torch.from_numpy(table).to(cuda)
    fn = lk.sign_lookup if sign else lk.table_lookup
    plain = lk.sign_lookup_plain if sign else lk.table_lookup_plain
    _assert_same_bytes(fn(tb, tt), plain(tb, tt))


def _raw_launch(bins, table, out, sign):
    """The kernel on any ``out`` (the wrapper allocates its own)."""
    rc = lk._kernel_lib().table_lookup(
        bins.data_ptr(), bins.element_size(), table.data_ptr(),
        table.element_size(), table.numel(), out.data_ptr(), int(sign),
        bins.numel(), torch.cuda.get_device_properties(
            bins.device).multi_processor_count,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("bin_dtype", BIN_DTYPES)
@pytest.mark.parametrize("offset", range(1, 16))
def test_kernel_unaligned_bins_and_output(cuda, offset, bin_dtype,
                                          table_dtype, sign):
    """Bin views and output views 1-15 elements past a 16-byte boundary
    (the scalar path), each alone and both together; the elements around
    the output view stay untouched."""
    bins, table = _case(10_007 + offset, bin_dtype, table_dtype)
    tb, tt = torch.from_numpy(bins).to(cuda), torch.from_numpy(table).to(cuda)
    plain = lk.sign_lookup_plain if sign else lk.table_lookup_plain
    fn = lk.sign_lookup if sign else lk.table_lookup
    view = tb[offset:]
    _assert_same_bytes(fn(view, tt), plain(view, tt))
    n = 10_007
    for b in (tb[:n], tb[offset:offset + n]):
        ref = plain(b, tt)
        store = torch.zeros(n + 32, dtype=ref.dtype, device=cuda)
        store.view(torch.uint8).fill_(0x5A)
        before = store.view(torch.uint8).clone()     # bytes, not bools
        store_bytes = store.view(torch.uint8)
        out = store[offset:offset + n]
        _raw_launch(b, tt, out, sign)
        _assert_same_bytes(out, ref)
        assert torch.equal(store_bytes[:offset * ref.element_size()],
                           before[:offset * ref.element_size()])
        assert torch.equal(store_bytes[(offset + n) * ref.element_size():],
                           before[(offset + n) * ref.element_size():])


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("over", [0, 1])
def test_kernel_table_at_and_over_the_staging_limit(cuda, over, table_dtype,
                                                    sign):
    """int32 bins into a table of exactly 48 KB of entries (staged in
    shared memory) and of one entry more (read through the read-only
    cache); in sign mode an entry is one byte."""
    entry = 1 if sign else np.dtype(table_dtype).itemsize
    num_bins = 48 * 1024 // entry + over
    rng = np.random.default_rng(num_bins)
    table = rng.normal(0, 1, num_bins).astype(table_dtype)
    bins = rng.integers(0, num_bins, 300_017).astype(np.int32)
    tb, tt = torch.from_numpy(bins).to(cuda), torch.from_numpy(table).to(cuda)
    fn = lk.sign_lookup if sign else lk.table_lookup
    plain = lk.sign_lookup_plain if sign else lk.table_lookup_plain
    _assert_same_bytes(fn(tb, tt), plain(tb, tt))


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
@pytest.mark.parametrize("num_bins", [256, 20_000])
def test_kernel_out_of_range_bins_give_zero(cuda, num_bins, table_dtype,
                                            sign):
    """int32 bins below 0 or at and past ``num_bins`` (on both sides of
    a 16-byte group, staged and unstaged tables) give 0 / False."""
    rng = np.random.default_rng(5)
    table = rng.normal(0, 1, num_bins).astype(table_dtype)
    bins = rng.integers(0, num_bins, 100_003).astype(np.int32)
    bad = rng.random(bins.shape) < 0.3
    bins[bad] = rng.choice(np.array([-1, -2 ** 31, num_bins, num_bins + 1,
                                     2 ** 31 - 1], np.int32), int(bad.sum()))
    tb, tt = torch.from_numpy(bins).to(cuda), torch.from_numpy(table).to(cuda)
    ok = torch.from_numpy(~bad).to(cuda)
    safe = torch.where(ok, tb, 0)
    if sign:
        ref = lk.sign_lookup_plain(safe, tt) & ok
        _assert_same_bytes(lk.sign_lookup(tb, tt), ref)
    else:
        ref = torch.where(ok, lk.table_lookup_plain(safe, tt), 0)
        _assert_same_bytes(lk.table_lookup(tb, tt), ref)


# ----------------------------------------------------------------------
# region-growing entries run on the card by default
# ----------------------------------------------------------------------
def _tube():
    return tube_phantom((12, 16, 20), seed=4)


def _entries():
    vol, seed = _tube()
    vm = np.where(seed, 0, 3)
    vm[:2] = 4
    return {
        "region_grow": lambda **kw: region_grow(vol, seed, iter_max=3, **kw),
        "region_grow_xla": lambda **kw: region_grow(
            vol, seed, vm == 4, backend="xla", iter_max=3, **kw),
        "region_grow_frontier": lambda **kw: region_grow_frontier(
            vol, seed, iter_max=3, **kw),
        "region_grow_fused": lambda **kw: region_grow_fused(
            vol, seed, iter_max=3, **kw),
        "region_grow_value_map": lambda **kw: region_grow_value_map(
            vol, vm, iter_max=3, **kw),
        "reconstruct_value_map": lambda **kw: reconstruct_value_map(
            seed, vm != 4, **kw),
    }


@pytest.mark.parametrize("entry", ["region_grow", "region_grow_xla",
                                   "region_grow_frontier",
                                   "region_grow_fused",
                                   "region_grow_value_map",
                                   "reconstruct_value_map"])
def test_host_arrays_go_to_the_card(entry):
    """With no ``device``, host arrays go to "cuda": without a CUDA device
    torch raises; nothing quietly runs on the CPU.  With one, the
    growers' results lie on it and the full-grid grower launches K7."""
    call = _entries()[entry]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            call()
        return
    n0 = lk.sign_lookup.launches
    out = call()
    if hasattr(out, "segmented_map"):
        assert out.segmented_map.device.type == "cuda"
    if entry in ("region_grow_xla", "region_grow_value_map"):
        assert lk.sign_lookup.launches > n0


@pytest.mark.parametrize("entry", ["region_grow", "region_grow_xla",
                                   "region_grow_frontier",
                                   "region_grow_fused",
                                   "region_grow_value_map",
                                   "reconstruct_value_map"])
def test_cpu_on_request_runs_plain(entry):
    """``device="cpu"`` (or CPU tensors) keeps the work on the CPU, on the
    plain versions: no kernel launch."""
    n0 = (lk.sign_lookup.launches, lk.table_lookup.launches)
    out = _entries()[entry](device="cpu")
    assert (lk.sign_lookup.launches, lk.table_lookup.launches) == n0
    if hasattr(out, "segmented_map"):
        assert out.segmented_map.device.type == "cpu"
    vol, seed = _tube()
    res = region_grow(torch.from_numpy(vol), torch.from_numpy(seed),
                      iter_max=3)
    assert res.segmented_map.device.type == "cpu"


def test_fused_grower_takes_host_arrays():
    vol, seed = _tube()
    kw = dict(max_segment_size=10 ** 6, iter_max=50, device="cpu")
    a = region_grow_fused(vol, seed, **kw)
    b = region_grow(vol, seed, backend="xla", **kw)
    assert torch.equal(a.segmented_map, b.segmented_map)
    assert int(a.iterations) == int(b.iterations) > 0


@pytest.mark.parametrize("shape,p", [((9, 14, 13), 0.3), ((4, 30, 7), 0.6)])
def test_reconstruct_value_map_matches_jax(jref, shape, p):
    from arterynetwork_tpu.ops.region_grow import \
        reconstruct_value_map as j_reconstruct

    rng = np.random.default_rng(int(p * 10))
    seg = rng.random(shape) < p
    seg[:, 9:] = False                  # outside voxels (state 3)
    seg[1:4, 2:8, 1:6] = True           # interior voxels (state 0)
    active = seg | (rng.random(shape) < 0.7)
    ref = j_reconstruct(seg, active)
    out = reconstruct_value_map(seg, active, device="cpu")
    assert out.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(out, ref)
    assert set(np.unique(out)) == {0, 1, 2, 3, 4}
