from repro_torch.utils import buckets  # noqa: F401
from repro_torch.utils.trees import (  # noqa: F401
    global_norm,
    tree_cast,
    tree_cosine_similarity,
    tree_size,
    tree_zeros_like,
)
