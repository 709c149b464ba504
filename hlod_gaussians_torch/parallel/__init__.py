from hlod_gaussians_torch.parallel.data_parallel import (  # noqa: F401
    make_mesh,
    shard_train_state,
    dp_train_step,
)
