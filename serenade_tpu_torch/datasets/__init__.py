from serenade_tpu_torch.datasets.feats_dataset import (  # noqa: F401
    FeatsDataset,
    FeatsDatasetNew,
)
from serenade_tpu_torch.datasets.audio_dataset import (  # noqa: F401
    AudioSCPDataset,
)
