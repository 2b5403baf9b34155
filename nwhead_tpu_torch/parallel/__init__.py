"""The device mesh (``mesh.py``): support-sharded serving
(``sharded_bank.py``) and data-parallel training (``data_parallel.py``,
imported by itself: it needs the model code, which a loaded serving
artifact does not import)."""

from nwhead_tpu_torch.parallel.mesh import (
    Mesh,
    column_parallel_dense,
    data_sharding,
    make_mesh,
    model_sharding,
    replicated,
    support_sharding,
)
from nwhead_tpu_torch.parallel.sharded_bank import (
    ShardedSupportBank,
    merge_partials,
    nw_partials,
    sharded_ensemble_predict_fn,
    sharded_knn_predict_fn,
)

__all__ = ["Mesh", "make_mesh", "data_sharding", "support_sharding", "replicated",
           "model_sharding", "column_parallel_dense", "ShardedSupportBank", "merge_partials",
           "nw_partials", "sharded_ensemble_predict_fn", "sharded_knn_predict_fn"]
