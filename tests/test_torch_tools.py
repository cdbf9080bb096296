"""The port's small tools against the JAX package's: the argparse
coercions of ``utils/types.py`` and the plots of ``utils/plot.py``."""

import argparse

import numpy as np
import pytest
import torch

from serenade_tpu.utils import types as jax_types

from serenade_tpu_torch.utils import plot, types


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn, value):
    try:
        return ("value", fn(value))
    except (argparse.ArgumentTypeError, ValueError) as exc:
        return ("error", type(exc).__name__)


INPUTS = ("yes", "TRUE", "t", "Y", "1", "no", "False", "f", "N", "0", "",
          "none", "NULL", "None", "3", "-7", "2.5", "1e-3", "inf", "nan",
          "maybe", "x1")


@pytest.mark.parametrize("name", ["str2bool", "int_or_none",
                                  "float_or_none", "str_or_none"])
def test_coercions_equal_jax(name):
    """Each coercion gives JAX's value, or raises JAX's error, on every
    input of the table (a bool passes str2bool through)."""
    port, ref = getattr(types, name), getattr(jax_types, name)
    for value in INPUTS:
        got, want = _outcome(port, value), _outcome(ref, value)
        if want[0] == "value" and isinstance(want[1], float) \
                and np.isnan(want[1]):
            assert got[0] == "value" and np.isnan(got[1]), value
        else:
            assert got == want, (name, value, got, want)
    if name == "str2bool":
        assert port(True) is True and port(False) is False


def test_preprocess_takes_its_str2bool_from_types():
    from serenade_tpu_torch.bin import preprocess

    assert preprocess.str2bool is types.str2bool
    args = preprocess.build_argparser().parse_args(
        ["--wav-scp", "w.scp", "--dumpdir", "d", "--config", "c.yml",
         "--skip-gtmidi", "yes"])
    assert args.skip_gtmidi is True


def test_plots_write_pngs(tmp_path):
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(40, 16)).astype(np.float32)
    f0 = np.where(rng.random(40) > 0.3, 200 + 20 * rng.random(40), 0.0)
    paths = [tmp_path / n for n in ("mel.png", "pair.png", "f0.png")]
    plot.plot_mel(str(paths[0]), mel, title="a mel")
    plot.plot_mel_pair(str(paths[1]), mel, mel[::-1])
    plot.plot_f0(str(paths[2]), [f0, f0 * 1.1], labels=["src", "conv"])
    for p in paths:
        data = p.read_bytes()
        assert len(data) > 1000 and data[:8] == b"\x89PNG\r\n\x1a\n", p


# --- the last public pieces: masks, utils re-exports, the registry, the F0
# stand-in and the small methods ------------------------------------------


def _mask_cases():
    lengths = np.array([0, 3, 7, 7])
    # (start, end): empty, inside, running to maxlen, the whole row
    segments = [(4, 4), (2, 5), (5, 7), (0, 7)]
    return lengths, 7, segments


@pytest.mark.parametrize("helper", ["make_pad_mask", "make_non_pad_mask",
                                    "segment_mask"])
def test_masks_equal_jax(helper):
    """Bool masks equal JAX's; segment masks too, with their bounds given
    as 0-d tensors (the train step's draw) and as ints."""
    import jax.numpy as jnp

    from serenade_tpu.utils import masking as jm

    from serenade_tpu_torch.utils import masking as pm

    lengths, maxlen, segments = _mask_cases()
    if helper != "segment_mask":
        got = getattr(pm, helper)(torch.from_numpy(lengths), maxlen)
        want = np.asarray(getattr(jm, helper)(jnp.asarray(lengths), maxlen))
        assert got.dtype == torch.bool and want.dtype == np.bool_
        np.testing.assert_array_equal(got.numpy(), want)
        return
    for start, end in segments:
        want = np.asarray(jm.segment_mask(jnp.int32(start), jnp.int32(end),
                                          maxlen))
        for bounds in ((torch.tensor(start), torch.tensor(end)),
                       (start, end)):
            got = pm.segment_mask(*bounds, maxlen)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    assert pm.segment_mask(1, 3, 4, dtype=torch.bool).dtype == torch.bool


def test_utils_reexports_are_the_submodules_objects():
    """``serenade_tpu_torch.utils`` re-exports what the JAX package's
    ``utils`` does, each the submodule's own object, and importing it
    imports no h5py."""
    import subprocess
    import sys

    import serenade_tpu.utils as jutils
    import serenade_tpu_torch.utils as putils
    from serenade_tpu_torch.utils import h5, masking, scalers

    jnames = {n for n in vars(jutils) if not n.startswith("_")
              and not isinstance(getattr(jutils, n), type(sys))}
    for name in sorted(jnames):
        obj = getattr(putils, name)
        owner = next(m for m in (h5, masking, scalers) if hasattr(m, name))
        assert obj is getattr(owner, name), name
    code = ("import sys, serenade_tpu_torch.utils; "
            "print('h5py' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "False"


def test_register_makes_a_config_name_resolve(monkeypatch):
    """A toy model registered by decorator resolves by its config name;
    ``registered("model")`` lists the built-ins (JAX's registered models),
    imported; an unknown name still raises with the known names."""
    import serenade_tpu.models  # noqa: F401 (JAX's registrations)
    from serenade_tpu import config as jconfig

    from serenade_tpu_torch import config as pconfig

    monkeypatch.setattr(pconfig, "_REGISTRY", {
        kind: dict(table) for kind, table in pconfig._REGISTRY.items()})

    @pconfig.register("model")
    class ToyModel(torch.nn.Module):
        pass

    @pconfig.register("model", "Toy2")
    class Renamed(torch.nn.Module):
        pass

    assert pconfig.resolve("model", "ToyModel") is ToyModel
    assert pconfig.resolve("model", "Toy2") is Renamed
    models = pconfig.registered("model")
    assert set(jconfig.registered("model")) <= set(models)
    from serenade_tpu_torch.models.serenade import Serenade

    assert models["Serenade"] is Serenade and models["ToyModel"] is ToyModel
    with pytest.raises(KeyError, match=r"unknown model 'Nope'; registered: "
                       r"\['NUSVC', 'Serenade', 'SerenadeNew', 'Toy2', "
                       r"'ToyModel'\]"):
        pconfig.resolve("model", "Nope")
    assert pconfig.registered("nothing") == {}


def _sung_with_silence(fs=24000):
    """0.3 s of silence, 1.2 s of a sung tone (vibrato, a note change,
    breath noise), 0.3 s of silence."""
    rng = np.random.default_rng(11)
    t = np.arange(int(1.2 * fs)) / fs
    note = np.where(t < 0.6, 262.0, 262.0 * 2 ** (4 / 12))
    phase = 2 * np.pi * np.cumsum(note * (1 + 0.01 * np.sin(
        2 * np.pi * 5.5 * t))) / fs
    tone = sum(a * np.sin(k * phase)
               for k, a in enumerate((0.3, 0.1, 0.05), 1))
    tone = tone * np.clip(np.minimum(t, 1.2 - t) / 0.03, 0, 1)
    tone = tone + 0.003 * rng.normal(size=t.size)
    gap = np.zeros(int(0.3 * fs))
    return np.concatenate([gap, tone, gap]).astype(np.float32)


def test_world_extract_compatible_matches_jax():
    """YIN, the median smoothing and ``vuv = f0 > 0``: vuv equal to JAX's
    on every frame, f0 within the port's YIN tolerance (1e-3 relative,
    ``test_torch_features.assert_f0_agrees``); host arrays out, and the
    card by default."""
    from serenade_tpu.ops import f0 as jf0

    from serenade_tpu_torch.ops import f0 as pf0

    x = _sung_with_silence()
    f0, vuv = pf0.world_extract_compatible(x, 24000, 80, 800, device="cpu")
    f0_j, vuv_j = jf0.world_extract_compatible(x, 24000, 80, 800)
    assert isinstance(f0, np.ndarray) and f0.dtype == np.float32
    assert f0.shape == f0_j.shape and vuv.dtype == np.float32
    np.testing.assert_array_equal(vuv, vuv_j)
    assert 0 < vuv.sum() < vuv.size
    voiced = vuv > 0
    rel = np.abs(f0[voiced] - f0_j[voiced]) / f0_j[voiced]
    assert rel.max() <= 1e-3, rel.max()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pf0.world_extract_compatible(x, 24000, 80, 800)


def test_small_methods_equal_jax(tmp_path):
    """``Serenade.conditioning_dim`` (with and without the F0 fluctuation
    channels), ``AudioSCPDataset.utt_ids``, ``QTensor.dtype`` and the
    preprocess CLI's ``make_midi_transcribe_fn`` without a checkpoint."""
    from serenade_tpu.datasets.audio_dataset import AudioSCPDataset as JDS
    from serenade_tpu.models.serenade import Serenade as JS
    from serenade_tpu.models.serenade_new import SerenadeNew as JSN

    from serenade_tpu_torch.bin.preprocess import make_midi_transcribe_fn
    from serenade_tpu_torch.datasets.audio_dataset import AudioSCPDataset
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.models.serenade_new import SerenadeNew
    from serenade_tpu_torch.quantize import quantize_leaf

    cfg = dict(input_dim=8, output_dim=12, encoder_channels=6)
    with torch.device("meta"):
        assert Serenade(**cfg).conditioning_dim == JS(**cfg).conditioning_dim
        assert (SerenadeNew(**cfg).conditioning_dim
                == JSN(**cfg).conditioning_dim == 6 + 2 + 2 + 12)
    scp = tmp_path / "wav.scp"
    scp.write_text("b b.wav\na a.wav\nc c.wav\n")
    assert AudioSCPDataset(str(scp)).utt_ids == JDS(str(scp)).utt_ids
    assert quantize_leaf(torch.ones(4, 3)).dtype == torch.float32
    assert make_midi_transcribe_fn(None) is None
