from hlod_gaussians_torch.hierarchy.build import (  # noqa: F401
    PaddedHierarchy,
    build_hierarchy_padded,
    compact_hierarchy,
    build_hierarchy,
)
from hlod_gaussians_torch.hierarchy.cut import (  # noqa: F401
    CutResult,
    expand_to_size_dynamic,
    expand_to_size_box,
    expand_to_target,
    is_hierarchy_cut,
    sanity_check_hierarchy,
    interpolate_with_parents,
)
from hlod_gaussians_torch.hierarchy.spt import (  # noqa: F401
    SPTForest,
    SPTCut,
    build_spt,
    spt_cut,
)
from hlod_gaussians_torch.hierarchy.mcmc import (  # noqa: F401
    compute_relocation,
    relocate_gs,
    add_new_gs,
)
from hlod_gaussians_torch.hierarchy.filter import (  # noqa: F401
    appearance_filter_mask,
    random_cut_mask,
    sibling_weights,
)
