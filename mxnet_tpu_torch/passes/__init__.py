"""mxnet_tpu_torch.passes: the graph-optimization pass pipeline between
Symbol construction and the Executor, and the fusion codegen that turns
its `__fusion_group__` chains into generated CUDA kernels (codegen.py).

Run at every bind (`optimize_for_bind`, behind MXNET_GRAPH_PASSES,
memoized per graph). The cost model and the autotuner of the JAX
package wait for a later slice.
"""
from __future__ import annotations

from . import codegen, ir, transforms  # noqa: F401
from .codegen import (  # noqa: F401
    REDUCE_OPS,
    CodegenConfig,
    CodegenPlan,
    FusedGroup,
    GeneratedKernel,
    build_groups,
    codegen_config,
    fusion_group_records,
    fusion_stats,
    group_digest,
    group_lax_fn,
    group_source,
    launch_counts,
    parity_error,
    plan_for,
    reset_fusion_stats,
    reset_launch_counts,
)
from .ir import Graph, GraphNode  # noqa: F401
from .manager import (  # noqa: F401
    PassManager,
    clear_memo,
    default_pipeline,
    graph_pass_stats,
    list_passes,
    optimize,
    optimize_for_bind,
    pipeline_spec,
    register_pass,
    reset_pass_stats,
)
from .transforms import ELEMWISE_OPS  # noqa: F401
