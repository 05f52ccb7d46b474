"""Input pipeline of the port: the synthetic stream, the procedural split
(streamed, or staged on the card: `device_resident.py`), the file loaders
(the native decode pool, the decode-once cache, the TFRecord reader;
imported where used), the dataset dispatch and the host-to-device
prefetcher."""

from gvcnn_tf_tpu_torch.data.pipeline import (  # noqa: F401
    dataset_size,
    make_dataset,
)
from gvcnn_tf_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: F401
from gvcnn_tf_tpu_torch.data.procedural import (  # noqa: F401
    ProceduralStream,
    procedural_dataset,
)
from gvcnn_tf_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticStream,
    synthetic_dataset,
)
