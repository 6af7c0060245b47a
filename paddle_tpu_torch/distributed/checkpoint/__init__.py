"""The checkpoint format (counterpart of
``paddle_tpu/distributed/checkpoint``): one ``.npy`` shard per tensor
plus a metadata JSON, byte for byte what the JAX package writes for the
same state, so either package reads the other's checkpoints. See
``save_load.py``."""
from .metadata import Metadata, ShardMeta, TensorMeta  # noqa: F401
from .save_load import load_state_dict, save_state_dict  # noqa: F401
