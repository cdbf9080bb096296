from serenade_tpu_torch.models.serenade import Serenade  # noqa: F401
from serenade_tpu_torch.models.serenade_new import SerenadeNew  # noqa: F401
from serenade_tpu_torch.models.cfm import CFM  # noqa: F401
from serenade_tpu_torch.models.unet import Decoder  # noqa: F401
from serenade_tpu_torch.models.gst import StyleEncoder  # noqa: F401
from serenade_tpu_torch.models.conv1d_resnet import Conv1dResnet  # noqa: F401
from serenade_tpu_torch.models.nusvc import NUSVC  # noqa: F401
