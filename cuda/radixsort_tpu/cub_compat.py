"""CUB-shaped compatibility surface — DeviceRadixSort / DeviceSegmentedRadixSort.

A user of the reference stack (`cub::DeviceRadixSort`,
`device_radix_sort.cuh:339-3152`; `cub::DeviceSegmentedRadixSort`,
`device_segmented_radix_sort.cuh`) can switch to this module and find the
same entry points with the same knobs:

    from cuda.radixsort_tpu.cub_compat import DeviceRadixSort, DoubleBuffer

    out = DeviceRadixSort.SortKeys(keys, begin_bit=0, end_bit=32)
    k, v = DeviceRadixSort.SortPairs(keys, values)
    k, v = DeviceRadixSort.SortPairsDescending(keys, values)
    buf = DoubleBuffer(keys)
    buf = DeviceRadixSort.SortKeys(buf)          # buf.current() is sorted

Differences dictated by the platform, not hidden:
  * no d_temp_storage two-phase size query — XLA owns allocation (the CUB
    nullptr-call protocol exists to size scratch; here `jax.jit` does it);
  * everything is functional — "overwrite" is expressed by donating the
    input buffer (`jax.jit(..., donate_argnums=0)`), and DoubleBuffer is a
    thin selector object kept for call-site compatibility;
  * `stream` arguments are accepted and ignored (XLA schedules).
"""

from __future__ import annotations

from typing import Any

from cuda.radixsort_tpu.ops.segmented import segmented_sort as _segmented
from cuda.radixsort_tpu.ops.sort import sort as _sort
from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs


class DoubleBuffer:
    """cub::DoubleBuffer (util_type.cuh:735) compatibility selector.

    Functional backends have no ping-pong buffers; this object just tracks
    "current" so CUB-shaped call sites keep working. `alternate()` returns
    the previous current after a sort (CUB semantics: selector flips)."""

    def __init__(self, current, alternate=None):
        self._bufs = [current, alternate]
        self.selector = 0

    def current(self):
        return self._bufs[self.selector]

    def alternate(self):
        return self._bufs[1 - self.selector]

    def _flip_to(self, new_current):
        self._bufs[1 - self.selector] = self._bufs[self.selector]
        self._bufs[self.selector] = new_current
        return self


def _unwrap(x):
    return (x.current(), True) if isinstance(x, DoubleBuffer) else (x, False)


def _rewrap(out, orig, was_buffer):
    if was_buffer:
        return orig._flip_to(out)
    return out


class DeviceRadixSort:
    """Parity: cub::DeviceRadixSort (device_radix_sort.cuh:142)."""

    @staticmethod
    def SortKeys(d_keys, num_items: int | None = None, begin_bit: int = 0,
                 end_bit: int | None = None, stream: Any = None, *,
                 decomposer=None, config=None):
        """`decomposer`: CUB's custom-type protocol (util_type.cuh:528-567)
        — a callable mapping the key container to a tuple of arithmetic
        columns, most significant first; the sort is then the lexicographic
        struct sort. With a decomposer, d_keys is returned reordered as a
        tuple of those columns."""
        keys, wrapped = _unwrap(d_keys)
        if decomposer is not None:
            from cuda.radixsort_tpu.ops.sort import sort_struct

            cols = tuple(decomposer(keys))
            if begin_bit != 0 or end_bit is not None:
                raise ValueError("decomposer sorts are full-width "
                                 "lexicographic; begin_bit/end_bit are "
                                 "not supported")
            _check_items(cols[0], num_items)
            return sort_struct(cols, config=config)
        _check_items(keys, num_items)
        out = _sort(keys, begin_bit=begin_bit, end_bit=end_bit,
                    config=config)
        return _rewrap(out, d_keys, wrapped)


    @staticmethod
    def SortKeysDescending(d_keys, num_items: int | None = None,
                           begin_bit: int = 0, end_bit: int | None = None,
                           stream: Any = None, *, decomposer=None,
                           config=None):
        keys, wrapped = _unwrap(d_keys)
        if decomposer is not None:
            from cuda.radixsort_tpu.ops.sort import sort_struct

            cols = tuple(decomposer(keys))
            if begin_bit != 0 or end_bit is not None:
                raise ValueError("decomposer sorts are full-width "
                                 "lexicographic; begin_bit/end_bit are "
                                 "not supported")
            _check_items(cols[0], num_items)
            return sort_struct(cols, descending=True, config=config)
        _check_items(keys, num_items)
        out = _sort(keys, descending=True, begin_bit=begin_bit,
                    end_bit=end_bit, config=config)
        return _rewrap(out, d_keys, wrapped)

    @staticmethod
    def SortPairs(d_keys, d_values, num_items: int | None = None,
                  begin_bit: int = 0, end_bit: int | None = None,
                  stream: Any = None, *, decomposer=None, config=None):
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        if decomposer is not None:
            from cuda.radixsort_tpu.ops.sort import sort_struct

            cols = tuple(decomposer(keys))
            if begin_bit != 0 or end_bit is not None:
                raise ValueError("decomposer sorts are full-width "
                                 "lexicographic; begin_bit/end_bit are "
                                 "not supported")
            _check_items(cols[0], num_items)
            ok, ov = sort_struct(cols, values, config=config)
            return ok, _rewrap(ov, d_values, vw)
        _check_items(keys, num_items)
        ok, ov = _sort_pairs(keys, values, begin_bit=begin_bit,
                             end_bit=end_bit, config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)

    @staticmethod
    def SortPairsDescending(d_keys, d_values, num_items: int | None = None,
                            begin_bit: int = 0, end_bit: int | None = None,
                            stream: Any = None, *, decomposer=None,
                            config=None):
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        if decomposer is not None:
            from cuda.radixsort_tpu.ops.sort import sort_struct

            cols = tuple(decomposer(keys))
            if begin_bit != 0 or end_bit is not None:
                raise ValueError("decomposer sorts are full-width "
                                 "lexicographic; begin_bit/end_bit are "
                                 "not supported")
            _check_items(cols[0], num_items)
            ok, ov = sort_struct(cols, values, descending=True,
                                 config=config)
            return ok, _rewrap(ov, d_values, vw)
        _check_items(keys, num_items)
        ok, ov = _sort_pairs(keys, values, descending=True,
                             begin_bit=begin_bit, end_bit=end_bit,
                             config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)


class DeviceSegmentedRadixSort:
    """Parity: cub::DeviceSegmentedRadixSort (one sort per segment).

    d_begin_offsets/d_end_offsets follow CUB's API; the common contiguous
    case (end_offsets = begin_offsets[1:]) maps to one offsets array."""

    @staticmethod
    def _offsets(num_segments, d_begin_offsets, d_end_offsets, n):
        import jax.numpy as jnp

        if d_end_offsets is None:
            return d_begin_offsets
        # contiguous segments: [begin, end) chains; validate cheaply
        return jnp.concatenate(
            [d_begin_offsets[:num_segments], d_end_offsets[num_segments - 1:
                                                           num_segments]])

    @staticmethod
    def SortKeys(d_keys, num_items: int | None = None,
                 num_segments: int | None = None, d_begin_offsets=None,
                 d_end_offsets=None, begin_bit: int = 0,
                 end_bit: int | None = None, stream: Any = None, *,
                 descending: bool = False, config=None):
        keys, wrapped = _unwrap(d_keys)
        _check_items(keys, num_items)
        ns = num_segments or (d_begin_offsets.shape[0] - 1)
        offs = DeviceSegmentedRadixSort._offsets(
            ns, d_begin_offsets, d_end_offsets, keys.shape[0])
        out = _segmented(keys, offs, descending=descending,
                         num_segments_bound=ns, begin_bit=begin_bit,
                         end_bit=end_bit, config=config)
        return _rewrap(out, d_keys, wrapped)

    @staticmethod
    def SortPairs(d_keys, d_values, num_items: int | None = None,
                  num_segments: int | None = None, d_begin_offsets=None,
                  d_end_offsets=None, begin_bit: int = 0,
                  end_bit: int | None = None, stream: Any = None, *,
                  descending: bool = False, config=None):
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        _check_items(keys, num_items)
        ns = num_segments or (d_begin_offsets.shape[0] - 1)
        offs = DeviceSegmentedRadixSort._offsets(
            ns, d_begin_offsets, d_end_offsets, keys.shape[0])
        ok, ov = _segmented(keys, offs, values, descending=descending,
                            num_segments_bound=ns, begin_bit=begin_bit,
                            end_bit=end_bit, config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)

    @staticmethod
    def SortKeysDescending(*args, **kw):
        return DeviceSegmentedRadixSort.SortKeys(*args, descending=True,
                                                 **kw)

    @staticmethod
    def SortPairsDescending(*args, **kw):
        return DeviceSegmentedRadixSort.SortPairs(*args, descending=True,
                                                  **kw)


def _check_items(keys, num_items):
    if num_items is not None and num_items != keys.shape[0]:
        raise ValueError(
            f"num_items={num_items} != len(keys)={keys.shape[0]} — slice "
            "the array (XLA shapes are static)")


# ---------------------------------------------------------------------------
# The rest of the CUB device-wide suite. Selection/partition/unique ride the
# framework's stable-partition compaction engine; scan/reduce map to XLA's
# native cumsum/reduce; merge and
# histogram ride ops/merge.py and ops/histogram.py.
#
# Shape contract difference (platform, not hidden): CUB writes compacted
# output through a pointer and a d_num_selected_out scalar; XLA shapes are
# static, so every selecting op returns (padded_out, num_selected) — rows
# [0, num_selected) are the result.
# ---------------------------------------------------------------------------


class DeviceSelect:
    """Parity: cub::DeviceSelect (device_select.cuh)."""

    @staticmethod
    def Flagged(d_in, d_flags, num_items: int | None = None,
                stream: Any = None, *, config=None):
        from cuda.radixsort_tpu.ops.filter import filter_columns

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        (out,), count = filter_columns(d_flags.astype(bool), (x,),
                                       config=config)
        return _rewrap(out, d_in, wrapped), count

    @staticmethod
    def If(d_in, select_op, num_items: int | None = None,
           stream: Any = None, *, config=None):
        """select_op is a traceable elementwise predicate (array -> bool)."""
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        from cuda.radixsort_tpu.ops.filter import filter_columns

        (out,), count = filter_columns(select_op(x), (x,), config=config)
        return _rewrap(out, d_in, wrapped), count

    @staticmethod
    def FlaggedIf(d_in, d_flags, select_op, num_items: int | None = None,
                  stream: Any = None, *, config=None):
        """Keep items whose FLAG satisfies select_op (device_select.cuh
        FlaggedIf — the predicate applies to the flag, not the item)."""
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        from cuda.radixsort_tpu.ops.filter import filter_columns

        (out,), count = filter_columns(select_op(d_flags).astype(bool),
                                       (x,), config=config)
        return _rewrap(out, d_in, wrapped), count

    @staticmethod
    def Unique(d_in, num_items: int | None = None, stream: Any = None, *,
               config=None):
        from cuda.radixsort_tpu.ops.unique import unique

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        out, count = unique(x, config=config)
        return _rewrap(out, d_in, wrapped), count

    @staticmethod
    def UniqueByKey(d_keys, d_values, num_items: int | None = None,
                    stream: Any = None, *, config=None):
        from cuda.radixsort_tpu.ops.filter import filter_columns
        from cuda.radixsort_tpu.ops.unique import _run_starts

        k, kw = _unwrap(d_keys)
        v, vw = _unwrap(d_values)
        _check_items(k, num_items)
        (ok, ov), count = filter_columns(_run_starts(k), (k, v),
                                         config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw), count


class DevicePartition:
    """Parity: cub::DevicePartition (device_partition.cuh).

    Stronger guarantee than CUB: both the selected prefix AND the rejected
    suffix keep their relative input order (CUB reverses the rejects); the
    rejected rows sit at [num_selected, N) in order, not reversed.
    """

    @staticmethod
    def Flagged(d_in, d_flags, num_items: int | None = None,
                stream: Any = None, *, config=None):
        return DeviceSelect.Flagged(d_in, d_flags, num_items, stream,
                                    config=config)

    @staticmethod
    def If(d_in, select_op, num_items: int | None = None,
           stream: Any = None, *, config=None):
        return DeviceSelect.If(d_in, select_op, num_items, stream,
                               config=config)

    @staticmethod
    def ThreeWay(d_in, select_first_part_op, select_second_part_op,
                 num_items: int | None = None, stream: Any = None, *,
                 config=None):
        """cub::DevicePartition three-way split (device_partition.cuh:412,
        DispatchThreeWayPartitionIf): items matching the first predicate,
        then items matching the second (of the rest), then the unselected —
        ALL three stably ordered.

        ONE stable sort on the category id (the same route as the 1-bit
        filter), then dynamic rolls align each part at index 0. Returns (first_part, second_part,
        unselected, num_selected) with num_selected = (2,) int32 counts of
        the first two parts; each output is full length, valid in its
        prefix.
        """
        import jax
        import jax.numpy as jnp

        from cuda.radixsort_tpu.ops.sort import sort_pairs

        x, _ = _unwrap(d_in)
        leaves = jax.tree_util.tree_leaves(x)
        _check_items(leaves[0], num_items)
        first = select_first_part_op(x)
        second = jnp.logical_and(jnp.logical_not(first),
                                 select_second_part_op(x))
        cat = jnp.where(first, jnp.uint32(0),
                        jnp.where(second, jnp.uint32(1), jnp.uint32(2)))
        _, out = sort_pairs(cat, x, config=config)
        n1 = jnp.sum(first.astype(jnp.int32))
        n2 = jnp.sum(second.astype(jnp.int32))
        roll = lambda t, s: jax.tree_util.tree_map(
            lambda a: jnp.roll(a, -s, axis=0), t)
        return out, roll(out, n1), roll(out, n1 + n2), jnp.stack([n1, n2])


class DeviceRunLengthEncode:
    """Parity: cub::DeviceRunLengthEncode (device_run_length_encode.cuh)."""

    @staticmethod
    def Encode(d_in, num_items: int | None = None, stream: Any = None, *,
               config=None):
        from cuda.radixsort_tpu.ops.unique import run_length_encode

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return run_length_encode(x, config=config)

    @staticmethod
    def NonTrivialRuns(d_in, num_items: int | None = None,
                       stream: Any = None, *, config=None):
        from cuda.radixsort_tpu.ops.unique import non_trivial_runs

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return non_trivial_runs(x, config=config)


class DeviceHistogram:
    """Parity: cub::DeviceHistogram (device_histogram.cuh). num_levels
    follows CUB: bins = num_levels - 1."""

    @staticmethod
    def HistogramEven(d_samples, num_levels: int, lower_level, upper_level,
                      num_samples: int | None = None, stream: Any = None):
        from cuda.radixsort_tpu.ops.histogram import histogram_even

        x, _ = _unwrap(d_samples)
        _check_items(x, num_samples)
        return histogram_even(x, num_levels - 1, lower_level, upper_level)

    @staticmethod
    def HistogramRange(d_samples, num_levels: int, d_levels,
                       num_samples: int | None = None, stream: Any = None):
        from cuda.radixsort_tpu.ops.histogram import histogram_range

        x, _ = _unwrap(d_samples)
        _check_items(x, num_samples)
        return histogram_range(x, d_levels[:num_levels])

    @staticmethod
    def MultiHistogramEven(d_samples, num_levels, lower_level, upper_level,
                           num_pixels: int | None = None,
                           stream: Any = None, *,
                           num_channels: int | None = None,
                           num_active_channels: int | None = None):
        """Interleaved multi-channel histograms (e.g. RGBA pixels):
        d_samples is (pixels, channels) or flat channel-interleaved; one
        histogram per active channel, each with its own levels. Channel
        de-interleave is a reshape — the per-channel histograms then run
        on the same bincount as the single-channel op."""
        import jax.numpy as jnp

        from cuda.radixsort_tpu.ops.histogram import histogram_even

        x, _ = _unwrap(d_samples)
        if x.ndim == 1:
            if num_channels is None:
                raise ValueError("flat samples need num_channels=")
            x = x.reshape(-1, num_channels)
        nch = x.shape[1]
        nact = nch if num_active_channels is None else num_active_channels
        _check_items(x, num_pixels)

        def per(i, spec):
            return spec[i] if isinstance(spec, (list, tuple)) else spec

        return tuple(
            histogram_even(x[:, c], per(c, num_levels) - 1,
                           per(c, lower_level), per(c, upper_level))
            for c in range(nact))

    @staticmethod
    def MultiHistogramRange(d_samples, num_levels, d_levels,
                            num_pixels: int | None = None,
                            stream: Any = None, *,
                            num_channels: int | None = None,
                            num_active_channels: int | None = None):
        """Range-binned sibling of MultiHistogramEven: d_levels is one
        levels array per active channel."""
        from cuda.radixsort_tpu.ops.histogram import histogram_range

        x, _ = _unwrap(d_samples)
        if x.ndim == 1:
            if num_channels is None:
                raise ValueError("flat samples need num_channels=")
            x = x.reshape(-1, num_channels)
        nch = x.shape[1]
        nact = nch if num_active_channels is None else num_active_channels
        _check_items(x, num_pixels)

        def per(i, spec):
            return spec[i] if isinstance(spec, (list, tuple)) else spec

        return tuple(
            histogram_range(x[:, c], per(c, d_levels)[: per(c, num_levels)])
            for c in range(nact))


class DeviceMerge:
    """Parity: cub::DeviceMerge (device_merge.cuh), less-comparator
    semantics (descending=True for greater)."""

    @staticmethod
    def MergeKeys(d_keys1, d_keys2, num_items1: int | None = None,
                  num_items2: int | None = None, stream: Any = None, *,
                  descending: bool = False, config=None):
        from cuda.radixsort_tpu.ops.merge import merge_sorted

        a, _ = _unwrap(d_keys1)
        b, _ = _unwrap(d_keys2)
        _check_items(a, num_items1)
        _check_items(b, num_items2)
        return merge_sorted(a, b, descending=descending, config=config)

    @staticmethod
    def MergePairs(d_keys1, d_values1, d_keys2, d_values2,
                   num_items1: int | None = None,
                   num_items2: int | None = None, stream: Any = None, *,
                   descending: bool = False, config=None):
        from cuda.radixsort_tpu.ops.merge import merge_sorted_pairs

        a, _ = _unwrap(d_keys1)
        b, _ = _unwrap(d_keys2)
        _check_items(a, num_items1)
        _check_items(b, num_items2)
        return merge_sorted_pairs(a, d_values1, b, d_values2,
                                  descending=descending, config=config)


class DeviceScan:
    """Parity: cub::DeviceScan (device_scan.cuh). XLA's fused cumulative
    ops are the spine scan — same role as RadixSortScanBinsKernel
    writ device-wide."""

    @staticmethod
    def ExclusiveSum(d_in, num_items: int | None = None, stream: Any = None):
        import jax.numpy as jnp

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        out = jnp.cumsum(x, dtype=x.dtype) - x
        return _rewrap(out, d_in, wrapped)

    @staticmethod
    def InclusiveSum(d_in, num_items: int | None = None, stream: Any = None):
        import jax.numpy as jnp

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        return _rewrap(jnp.cumsum(x, dtype=x.dtype), d_in, wrapped)

    @staticmethod
    def ExclusiveScan(d_in, scan_op, initial_value,
                      num_items: int | None = None, stream: Any = None):
        """scan_op: traceable associative binary op (e.g. jnp.minimum).
        Runs on the doubling-scan path (ops/scan.py) — associative_scan
        does not compile at >=2^21 elements on this backend."""
        import jax.numpy as jnp

        from cuda.radixsort_tpu.ops.scan import plain_scan

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        init = jnp.asarray(initial_value, x.dtype)
        inc = plain_scan(x, scan_op, identity=initial_value)
        out = jnp.concatenate([init[None], scan_op(init, inc[:-1])])
        return _rewrap(out, d_in, wrapped)

    @staticmethod
    def InclusiveScan(d_in, scan_op, num_items: int | None = None,
                      stream: Any = None):
        from cuda.radixsort_tpu.ops.scan import plain_scan

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        return _rewrap(plain_scan(x, scan_op), d_in, wrapped)

    @staticmethod
    def InclusiveScanInit(d_in, scan_op, init_value,
                          num_items: int | None = None, stream: Any = None):
        """Inclusive scan with `init_value` folded into the first element
        (device_scan.cuh:1144)."""
        import jax
        import jax.numpy as jnp

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        from cuda.radixsort_tpu.ops.scan import plain_scan

        out = scan_op(jnp.asarray(init_value, x.dtype),
                      plain_scan(x, scan_op))
        return _rewrap(out, d_in, wrapped)

    # ---- by-key scans (device_scan.cuh:1178-1801): segments are runs of
    # consecutive equal keys; backed by ops/scan.py's segmented monoid.

    @staticmethod
    def InclusiveSumByKey(d_keys_in, d_values_in,
                          num_items: int | None = None,
                          equality_op=None, stream: Any = None):
        from cuda.radixsort_tpu.ops.scan import scan_by_key

        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, "sum", equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)

    @staticmethod
    def ExclusiveSumByKey(d_keys_in, d_values_in,
                          num_items: int | None = None,
                          equality_op=None, stream: Any = None):
        from cuda.radixsort_tpu.ops.scan import scan_by_key

        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, "sum", exclusive=True,
                          equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)

    @staticmethod
    def InclusiveScanByKey(d_keys_in, d_values_in, scan_op,
                           num_items: int | None = None,
                           equality_op=None, stream: Any = None):
        """scan_op: "sum"|"prod"|"min"|"max" or a traceable associative
        binary op."""
        from cuda.radixsort_tpu.ops.scan import scan_by_key

        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, scan_op, equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)

    @staticmethod
    def ExclusiveScanByKey(d_keys_in, d_values_in, scan_op, init_value,
                           num_items: int | None = None,
                           equality_op=None, stream: Any = None, *,
                           identity=None):
        """init_value seeds EVERY segment (CUB contract). A callable
        scan_op additionally needs identity= (its neutral element)."""
        from cuda.radixsort_tpu.ops.scan import scan_by_key

        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, scan_op, exclusive=True, init=init_value,
                          identity=identity, equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)


class DeviceReduce:
    """Parity: cub::DeviceReduce (device_reduce.cuh)."""

    @staticmethod
    def Sum(d_in, num_items: int | None = None, stream: Any = None):
        import jax.numpy as jnp

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return jnp.sum(x)

    @staticmethod
    def Min(d_in, num_items: int | None = None, stream: Any = None):
        import jax.numpy as jnp

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return jnp.min(x)

    @staticmethod
    def Max(d_in, num_items: int | None = None, stream: Any = None):
        import jax.numpy as jnp

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return jnp.max(x)

    @staticmethod
    def ArgMin(d_in, num_items: int | None = None, stream: Any = None):
        """Returns (index, value) — CUB's KeyValuePair, first occurrence."""
        import jax.numpy as jnp

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        i = jnp.argmin(x)
        return i, x[i]

    @staticmethod
    def ArgMax(d_in, num_items: int | None = None, stream: Any = None):
        import jax.numpy as jnp

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        i = jnp.argmax(x)
        return i, x[i]

    @staticmethod
    def Reduce(d_in, reduction_op, init,
               num_items: int | None = None, stream: Any = None):
        """reduction_op: traceable associative binary op; init its identity
        (CUB passes init explicitly too)."""
        from cuda.radixsort_tpu.ops.scan import reduce_with

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return reduce_with(x, reduction_op, init)

    @staticmethod
    def TransformReduce(d_in, reduction_op, transform_op, init,
                        num_items: int | None = None, stream: Any = None):
        """Fused transform + reduce (device_reduce.cuh TransformReduce);
        XLA fuses the elementwise map into the reduction for free."""
        from cuda.radixsort_tpu.ops.scan import reduce_with

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return reduce_with(transform_op(x), reduction_op, init)

    @staticmethod
    def ReduceByKey(d_keys_in, d_values_in, reduction_op=None,
                    num_items: int | None = None, stream: Any = None, *,
                    config=None):
        """Reduce runs of CONSECUTIVE equal keys (device_reduce.cuh
        ReduceByKey — run-based, like thrust::reduce_by_key; this is NOT a
        global group-by). reduction_op: None (sum), "sum"|"prod"|"min"|
        "max", or a traceable associative binary op.

        Returns (unique_keys, aggregates, num_runs) — outputs padded past
        num_runs. Shape: one segmented inclusive scan (the run
        total lands on each run's LAST slot, where the keys still equal the
        run's key), then one stable compaction of the run-end rows — no
        atomics, no per-run launches.
        """
        import jax.numpy as jnp

        from cuda.radixsort_tpu.ops.filter import filter_columns
        from cuda.radixsort_tpu.ops.scan import scan_by_key

        k, _ = _unwrap(d_keys_in)
        v, _ = _unwrap(d_values_in)
        _check_items(v, num_items)
        op = "sum" if reduction_op is None else reduction_op
        scanned = scan_by_key(k, v, op)
        ends = jnp.concatenate(
            [k[1:] != k[:-1], jnp.ones((1,), bool)])
        (uk, agg), num_runs = filter_columns(ends, (k, scanned),
                                             config=config)
        return uk, agg, num_runs


class DeviceSegmentedReduce:
    """Parity: cub::DeviceSegmentedReduce (device_segmented_reduce.cuh).
    Offsets follow CUB: segment i = [begin[i], end[i]); the contiguous case
    passes end=None meaning end[i] = begin[i+1] (begin has num_segments+1
    entries). Empty segments yield the op's identity (CUB: initial value)."""

    @staticmethod
    def _seg(d_in, num_segments, d_begin, d_end, reducer):
        import jax.numpy as jnp

        x, _ = _unwrap(d_in)
        n = x.shape[0]
        ns = num_segments or (d_begin.shape[0] - 1)
        begin = d_begin[:ns].astype(jnp.int32)
        end = (begin if ns == 0 else
               (d_begin[1:ns + 1] if d_end is None else
                d_end[:ns])).astype(jnp.int32)
        idx = jnp.arange(n, dtype=jnp.int32)
        # empty segments (begin >= end) share begins with real ones and must
        # not win the searchsorted attribution: push them past every element
        key = jnp.where(begin >= end, jnp.int32(n + 1), begin)
        order = jnp.argsort(key)
        pos = jnp.searchsorted(jnp.take(key, order), idx,
                               side="right").astype(jnp.int32) - 1
        s = jnp.take(order, jnp.clip(pos, 0, ns - 1))
        # elements before the first segment or in an inter-segment gap -> ns
        inside = (pos >= 0) & (idx >= begin[s]) & (idx < end[s])
        return reducer(x, jnp.where(inside, s, jnp.int32(ns)),
                       num_segments=ns + 1)[:ns]

    @staticmethod
    def Sum(d_in, num_segments: int | None = None, d_begin_offsets=None,
            d_end_offsets=None, stream: Any = None):
        import jax

        return DeviceSegmentedReduce._seg(d_in, num_segments,
                                          d_begin_offsets, d_end_offsets,
                                          jax.ops.segment_sum)

    @staticmethod
    def Min(d_in, num_segments: int | None = None, d_begin_offsets=None,
            d_end_offsets=None, stream: Any = None):
        import jax

        return DeviceSegmentedReduce._seg(d_in, num_segments,
                                          d_begin_offsets, d_end_offsets,
                                          jax.ops.segment_min)

    @staticmethod
    def Max(d_in, num_segments: int | None = None, d_begin_offsets=None,
            d_end_offsets=None, stream: Any = None):
        import jax

        return DeviceSegmentedReduce._seg(d_in, num_segments,
                                          d_begin_offsets, d_end_offsets,
                                          jax.ops.segment_max)


class DeviceSegmentedSort:
    """Parity: cub::DeviceSegmentedSort (device_segmented_sort.cuh) — the
    small-segment-optimized cousin of DeviceSegmentedRadixSort. Here both
    map to the same segment-id-limb sort (ops/segmented.py), which is
    already stable, so Sort* == StableSort*."""

    SortKeys = staticmethod(DeviceSegmentedRadixSort.SortKeys)
    SortPairs = staticmethod(DeviceSegmentedRadixSort.SortPairs)
    SortKeysDescending = staticmethod(
        DeviceSegmentedRadixSort.SortKeysDescending)
    SortPairsDescending = staticmethod(
        DeviceSegmentedRadixSort.SortPairsDescending)
    StableSortKeys = staticmethod(DeviceSegmentedRadixSort.SortKeys)
    StableSortPairs = staticmethod(DeviceSegmentedRadixSort.SortPairs)
    StableSortKeysDescending = staticmethod(
        DeviceSegmentedRadixSort.SortKeysDescending)
    StableSortPairsDescending = staticmethod(
        DeviceSegmentedRadixSort.SortPairsDescending)


class DeviceAdjacentDifference:
    """Parity: cub::DeviceAdjacentDifference (device_adjacent_difference.cuh).
    Copy variants only — functional backend; difference_op defaults to
    subtraction and must be traceable elementwise."""

    @staticmethod
    def SubtractLeftCopy(d_in, num_items: int | None = None,
                         difference_op=None, stream: Any = None):
        import jax.numpy as jnp

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        op = difference_op or (lambda a, b: a - b)
        out = jnp.concatenate([x[:1], op(x[1:], x[:-1])])
        return _rewrap(out, d_in, wrapped)

    @staticmethod
    def SubtractRightCopy(d_in, num_items: int | None = None,
                          difference_op=None, stream: Any = None):
        import jax.numpy as jnp

        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        op = difference_op or (lambda a, b: a - b)
        out = jnp.concatenate([op(x[:-1], x[1:]), x[-1:]])
        return _rewrap(out, d_in, wrapped)

    SubtractLeft = SubtractLeftCopy
    SubtractRight = SubtractRightCopy


class DeviceTopK:
    """Parity: cub::DeviceTopK (device_topk.cuh) — MinKeys/MaxKeys/
    MinPairs/MaxPairs, backed by the radix-select + filter engine
    (ops/select.py: histogram refinement, ~4 reads, no full sort).
    Deterministic tie rule (stronger than CUB's unspecified choice):
    smallest original index wins; results sorted."""

    @staticmethod
    def MaxKeys(d_keys_in, k: int, num_items: int | None = None,
                stream: Any = None, *, config=None):
        from cuda.radixsort_tpu.ops.select import top_k

        x, _ = _unwrap(d_keys_in)
        _check_items(x, num_items)
        vals, _ = top_k(x, k, largest=True, config=config)
        return vals

    @staticmethod
    def MinKeys(d_keys_in, k: int, num_items: int | None = None,
                stream: Any = None, *, config=None):
        from cuda.radixsort_tpu.ops.select import top_k

        x, _ = _unwrap(d_keys_in)
        _check_items(x, num_items)
        vals, _ = top_k(x, k, largest=False, config=config)
        return vals

    @staticmethod
    def MaxPairs(d_keys_in, d_values_in, k: int,
                 num_items: int | None = None, stream: Any = None, *,
                 config=None):
        import jax.numpy as jnp

        from cuda.radixsort_tpu.ops.select import top_k

        x, _ = _unwrap(d_keys_in)
        v, _ = _unwrap(d_values_in)
        _check_items(x, num_items)
        vals, idx = top_k(x, k, largest=True, config=config)
        return vals, jnp.take(v, idx, axis=0)

    @staticmethod
    def MinPairs(d_keys_in, d_values_in, k: int,
                 num_items: int | None = None, stream: Any = None, *,
                 config=None):
        import jax.numpy as jnp

        from cuda.radixsort_tpu.ops.select import top_k

        x, _ = _unwrap(d_keys_in)
        v, _ = _unwrap(d_values_in)
        _check_items(x, num_items)
        vals, idx = top_k(x, k, largest=False, config=config)
        return vals, jnp.take(v, idx, axis=0)


class DeviceTransform:
    """Parity: cub::DeviceTransform (device_transform.cuh) — Transform over
    N input sequences with a traceable op (it exists in CUB to saturate
    bandwidth; here XLA fuses it into neighbors for free)."""

    @staticmethod
    def Transform(d_inputs, transform_op, num_items: int | None = None,
                  stream: Any = None):
        ins = d_inputs if isinstance(d_inputs, (tuple, list)) else (d_inputs,)
        xs = []
        for i in ins:
            x, _ = _unwrap(i)
            xs.append(x)
        _check_items(xs[0], num_items)
        return transform_op(*xs)


class DeviceMergeSort:
    """Parity: cub::DeviceMergeSort (device_merge_sort.cuh) — the
    comparison-sort companion of DeviceRadixSort: custom comparators and
    struct keys.

    Routing mirrors thrust smart_sort (THRUST sort.h:310-337): a less/greater
    marker on a plain array takes the sort engine; everything else
    takes the comparator network (ops/comparator_sort.py). `SortKeysCopy` /
    `StableSortKeysCopy` alias the plain entry points — a functional backend
    always returns a copy."""

    @staticmethod
    def SortKeys(d_keys, num_items: int | None = None, compare_op=None,
                 stream: Any = None, *, stable: bool = False, config=None):
        from cuda.radixsort_tpu.ops.comparator_sort import (
            comparator_sort, less, primitive_comparator)

        comp = less if compare_op is None else compare_op
        keys, wrapped = _unwrap(d_keys)
        prim, desc = primitive_comparator(comp)
        if prim and hasattr(keys, "dtype"):
            _check_items(keys, num_items)
            out = _sort(keys, descending=desc, config=config)
        else:
            out = comparator_sort(keys, comp, stable=stable)
        return _rewrap(out, d_keys, wrapped)

    @staticmethod
    def StableSortKeys(d_keys, num_items: int | None = None, compare_op=None,
                       stream: Any = None, *, config=None):
        return DeviceMergeSort.SortKeys(d_keys, num_items, compare_op,
                                        stream, stable=True, config=config)

    SortKeysCopy = SortKeys
    StableSortKeysCopy = StableSortKeys

    @staticmethod
    def SortPairs(d_keys, d_values, num_items: int | None = None,
                  compare_op=None, stream: Any = None, *,
                  stable: bool = False, config=None):
        from cuda.radixsort_tpu.ops.comparator_sort import (
            comparator_sort, less, primitive_comparator)

        comp = less if compare_op is None else compare_op
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        prim, desc = primitive_comparator(comp)
        if prim and hasattr(keys, "dtype") and hasattr(values, "dtype"):
            _check_items(keys, num_items)
            ok, ov = _sort_pairs(keys, values, descending=desc,
                                 config=config)
        else:
            ok, ov = comparator_sort(keys, comp, values=values,
                                     stable=stable)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)

    @staticmethod
    def StableSortPairs(d_keys, d_values, num_items: int | None = None,
                        compare_op=None, stream: Any = None, *, config=None):
        return DeviceMergeSort.SortPairs(d_keys, d_values, num_items,
                                         compare_op, stream, stable=True,
                                         config=config)


class DeviceCopy:
    """Parity: cub::DeviceCopy (device_copy.cuh). CUB's Batched copies
    num_buffers independent ranges in one launch (a tail-latency play for
    many small copies). The static-shape analogue: all source ranges
    live in ONE flat array, all destination ranges in another, and the
    whole batch is a single fused gather — searchsorted attributes each
    output slot to its buffer, so ragged buffers cost nothing extra."""

    @staticmethod
    def Batched(d_src, d_dst, src_offsets, dst_offsets, sizes,
                num_buffers: int | None = None, stream: Any = None):
        """Copy range i: src[src_offsets[i] : +sizes[i]] into
        dst[dst_offsets[i] : +sizes[i]]. Destination ranges must not
        overlap (CUB's contract too); they need not be sorted. Returns the
        updated dst (functional)."""
        import jax.numpy as jnp

        src, _ = _unwrap(d_src)
        dst, wrapped = _unwrap(d_dst)
        so = jnp.asarray(src_offsets, jnp.int32)
        do = jnp.asarray(dst_offsets, jnp.int32)
        sz = jnp.asarray(sizes, jnp.int32)
        if num_buffers is not None and so.shape[0] != num_buffers:
            raise ValueError(
                f"num_buffers={num_buffers} != offsets length {so.shape[0]}")
        nb = so.shape[0]
        if nb == 0:
            return _rewrap(dst, d_dst, wrapped)
        # zero-size buffers must not enter the searchsorted basis — an
        # empty buffer whose dst_offset lands inside another's range would
        # shadow it; push them past every destination index
        do = jnp.where(sz > 0, do, dst.shape[0])
        order = jnp.argsort(do)
        so, do, sz = so[order], do[order], sz[order]
        i = jnp.arange(dst.shape[0], dtype=jnp.int32)
        j = jnp.searchsorted(do, i, side="right").astype(jnp.int32) - 1
        jc = jnp.clip(j, 0, nb - 1)
        rel = i - do[jc]
        covered = (j >= 0) & (rel < sz[jc])
        src_idx = jnp.clip(so[jc] + rel, 0, src.shape[0] - 1)
        out = jnp.where(covered, src[src_idx], dst)
        return _rewrap(out, d_dst, wrapped)


class DeviceMemcpy:
    """Parity: cub::DeviceMemcpy (device_memcpy.cuh). Identical surface to
    DeviceCopy.Batched; CUB splits the classes only because Memcpy is
    byte-typed. Here ranges are in ELEMENTS of the given arrays (reshape/
    view to uint8 for byte semantics)."""

    Batched = DeviceCopy.Batched


class DeviceFor:
    """Parity: cub::DeviceFor (device_for.cuh). CUB's op(i) mutates global
    state; under XLA the functional equivalent returns op's value per
    index/item as an array (vmap), which the compiler fuses into
    neighboring ops — the same zero-materialization result as CUB's
    for-each-fused-into-load."""

    @staticmethod
    def Bulk(shape, op, stream: Any = None):
        """op over [0, shape) indices; returns stacked op(i)."""
        import jax
        import jax.numpy as jnp

        return jax.vmap(op)(jnp.arange(shape))

    @staticmethod
    def ForEach(d_in, op, num_items: int | None = None, stream: Any = None):
        import jax

        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return jax.vmap(op)(x)

    @staticmethod
    def ForEachN(d_in, num_items: int, op, stream: Any = None):
        import jax

        x, _ = _unwrap(d_in)
        return jax.vmap(op)(x[:num_items])

    # CUB distinguishes Copy variants only by load strategy (they copy
    # items to registers before applying op); functionally identical here.
    ForEachCopy = ForEach
    ForEachCopyN = ForEachN

    @staticmethod
    def ForEachInExtents(extents, op, stream: Any = None):
        """op(i0, i1, ...) over the index grid of `extents` (a tuple of
        static ints); returns an array shaped `extents`."""
        import jax
        import jax.numpy as jnp

        grids = jnp.meshgrid(
            *[jnp.arange(e) for e in extents], indexing="ij")
        flat = [g.reshape(-1) for g in grids]
        out = jax.vmap(lambda *idx: op(*idx))(*flat)
        return out.reshape(extents + out.shape[1:])
