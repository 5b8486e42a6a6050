"""Cloud Collectives core: cost models, solving, mesh reordering, simulation.

Copies of ``repro.core`` (numpy).  The manual chain, paper mapping::

    fabric  = repro_torch.fabric.make_datacenter(...)
    probed  = repro_torch.fabric.probe_fabric(fabric)    # §IV-B probing
    c       = repro_torch.fabric.cost_matrix(probed, S)  # c_{i,j}(S)
    result  = reorder.optimize_rank_order(c, "ring", S)  # §IV-C solving
    plan    = reorder.optimize_mesh_assignment(c, (8,), ("data",))
    # paper §VI: repair the order online as the fabric drifts
    reranker = dynamic.AdaptiveReranker(factory, perm=result.perm)
"""

from .cost_models import (  # noqa: F401
    COST_MODELS,
    AllToAllCost,
    BCubeCost,
    CostModel,
    DoubleBinaryTreeCost,
    HalvingDoublingCost,
    RingCost,
    make_cost_model,
)
from .dynamic import AdaptiveReranker, StragglerDetector, bottleneck_swap  # noqa: F401
from .reorder import (  # noqa: F401
    MeshPlan,
    hierarchical_perm,
    mesh_axis_cost,
    mesh_total_cost,
    optimize_mesh_assignment,
    optimize_rank_order,
    optimize_rank_order_hierarchical,
    random_assignment,
)
from .schedule import Flow  # noqa: F401
from .simulator import CollectiveSimulator, simulate_collective, simulate_rounds  # noqa: F401
from .solver import (  # noqa: F401
    SolveResult,
    exhaustive,
    greedy_ring,
    held_karp,
    or_opt,
    percentile_orders,
    solve,
    solve_sa,
    solve_worst,
    swap_hill_climb,
    two_opt,
)
