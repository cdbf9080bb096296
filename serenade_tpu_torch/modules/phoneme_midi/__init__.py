"""The phoneme-MIDI transcriber (counterpart of
serenade_tpu/modules/phoneme_midi/)."""

from serenade_tpu_torch.modules.phoneme_midi.decoding import (  # noqa: F401
    FramewiseDecoder,
)
from serenade_tpu_torch.modules.phoneme_midi.model import (  # noqa: F401
    PhonemeRecognitionModel, TranscriptionModel, load_transcriber,
)
