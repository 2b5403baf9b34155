"""Support-sharded serving over a device mesh (``mesh.py``,
``sharded_bank.py``)."""

from nwhead_tpu_torch.parallel.mesh import Mesh, make_mesh
from nwhead_tpu_torch.parallel.sharded_bank import (
    ShardedSupportBank,
    merge_partials,
    nw_partials,
    sharded_ensemble_predict_fn,
    sharded_knn_predict_fn,
)

__all__ = ["Mesh", "make_mesh", "ShardedSupportBank", "merge_partials", "nw_partials",
           "sharded_ensemble_predict_fn", "sharded_knn_predict_fn"]
