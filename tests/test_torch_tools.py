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
