"""repro_torch.segmented — CSR ragged sort / merge / top-k over size classes.

Static CSR offsets bucket into pow2 length classes, each class runs one
class-kernel launch (``kernels/segmented.py``). The public entry points are
``repro_torch.segment_sort / segment_merge / segment_topk /
segment_argmax``; ``set_segmented_enabled(False)`` (or
``REPRO_DISABLE_SEGMENTED=1``) routes their auto calls to the per-segment
plain version.
"""
from .bucketing import (SizeClass, bucket_merge_pairs, bucket_segments,  # noqa: F401
                        normalize_offsets, segment_lengths)
from .core import (MAX_CLASS_WIDTH, max_class_width, segment_argmax_impl,  # noqa: F401
                   segment_merge_impl, segment_sort_impl, segment_topk_impl,
                   segmented_enabled, set_segmented_enabled)
