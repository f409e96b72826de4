from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, cdiv, pad_to, resolve_device, round_up,
)
from pytorch_volumetric_tpu_torch.utils.cache import NpzStore, get_store
