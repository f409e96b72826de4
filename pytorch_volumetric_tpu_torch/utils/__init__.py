from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, flatten_batch, cdiv, round_up, pad_to, np_pad_to, resolve_device,
)
from pytorch_volumetric_tpu_torch.utils.cache import NpzStore, get_store
from pytorch_volumetric_tpu_torch.utils.debug import checked_query, guarded_raw_query
