"""cuda.radixsort_tpu — a vectorized query-execution engine in JAX.

A JAX / XLA / shard_map framework with the capabilities of the reference
CUDA LSD radix sort (truongchauhien/CUDA.RadixSort, canonical form: CUB
DeviceRadixSort), generalized into a full operator set (radix partition,
sort-merge join, group-by aggregate, predicate filter with selection
vectors) over device-resident column batches and scaled over a device mesh
with a skew-aware all-to-all shuffle. The per-digit pipeline — per-tile
digit histogram, exclusive prefix-scan over the striped spine, stable
scatter — stays as the 'reference' engine; the default engine is XLA's own
sort, which XLA:GPU lowers to CUB's radix sort where it can.

Public API (reference parity: CUB `device_radix_sort.cuh`, thrust `sort.h`):
    sort, sort_pairs, argsort       — stable radix sort (keys / key-value)
    SortConfig                      — engine choice (analogue of the CUB policy hub)
"""

from cuda.radixsort_tpu.config import (  # noqa: F401
    SortConfig,
    resolve,
)
from cuda.radixsort_tpu.ops.sort import (  # noqa: F401
    argsort,
    sort,
    sort_pairs,
    sort_struct,
)
from cuda.radixsort_tpu.ops.select import kth_value, top_k  # noqa: F401
from cuda.radixsort_tpu.ops.partition import bucket_ids, hash32, partition  # noqa: F401
from cuda.radixsort_tpu.ops.filter import filter_columns, selection_vector  # noqa: F401
from cuda.radixsort_tpu.ops.join import join  # noqa: F401
from cuda.radixsort_tpu.ops.aggregate import (  # noqa: F401
    groupby,
    groupby_multi,
    groupby_quantile,
)
from cuda.radixsort_tpu.ops.scan import scan_by_key, segmented_scan  # noqa: F401
from cuda.radixsort_tpu.ops.window import window  # noqa: F401
from cuda.radixsort_tpu.ops.external import (  # noqa: F401
    sort_external,
    sort_external_pairs,
)
from cuda.radixsort_tpu.ops.segmented import segmented_sort  # noqa: F401
from cuda.radixsort_tpu.ops.unique import (  # noqa: F401
    distinct,
    non_trivial_runs,
    run_length_encode,
    unique,
)
from cuda.radixsort_tpu.ops.merge import (  # noqa: F401
    merge_sorted,
    merge_sorted_pairs,
)
from cuda.radixsort_tpu.ops.setops import (  # noqa: F401
    set_difference,
    set_intersection,
    set_symmetric_difference,
    set_union,
)
from cuda.radixsort_tpu.ops.histogram import (  # noqa: F401
    digit_histogram,
    histogram_even,
    histogram_range,
)
from cuda.radixsort_tpu.ops.join import join_count, join_expand  # noqa: F401
from cuda.radixsort_tpu.ops.comparator_sort import (  # noqa: F401
    comparator_argsort,
    comparator_sort,
)
from cuda.radixsort_tpu.pipeline.plan import Query  # noqa: F401
from cuda.radixsort_tpu.table import Table, table  # noqa: F401
from cuda.radixsort_tpu import twiddle  # noqa: F401

__version__ = "0.1.0"
