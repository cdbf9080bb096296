"""SiFiGAN source-filter generator (counterpart of serenade_tpu/sifigan/
generator.py; Yoneyama et al., "Source-Filter HiFi-GAN", ICASSP 2023),
channels-last ``(B, T, C)``.

* **Sine embedding**: the excitation (waveform rate) is embedded by
  ``sn_emb`` and downsampled by strided convs ``sn_down{i}`` to every
  resolution.
* **Source network**: ``input_conv``'s features are upsampled level by
  level (``sn_up{i}``), the matching sine embedding added, and shaped by
  a quasi-periodic residual block (``sn_block{i}``): three 1x1 convs over
  the past, current and future taps ``x[t -+ round(d(t) dilation)]``,
  whose offset follows the pitch.  ``sn_output_conv`` emits the
  excitation.
* **Filter network**: the finest source features are downsampled back
  (``fn_down{i}``) and injected at each resolution of the filter's own
  upsample stack (``fn_up{i}``), refined by the mean of multi-kernel
  HiFiGAN residual blocks, then projected to the waveform with tanh.

The filter network's residual blocks run the HiFiGAN residual-branch
kernel (K3, ``csrc/resblock_branch.cu``) on the card, without additional
convs by default: one TF32 conv launch a dilation, the residual fused.
Training builds them with ``resblock_backend="conv"``, a differentiable
conv chain, as JAX trains through its ``conv`` lowering.
The pitch-dependent taps are index gathers and their three 1x1 convs
plain products, which JAX also computes outside Pallas.  Modules are
named as flax names them, so ``convert.py``'s bridge maps a flax tree
onto them, and ``sifigan/convert.py`` a released checkpoint.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from serenade_tpu_torch.models.layers import Conv1d, ConvTranspose1d, as_dtype
from serenade_tpu_torch.vocoder.layers import (
    HiFiGANResidualBlock, leaky_relu_01,
)

SOURCE_DILATIONS = ((1,), (1, 2), (1, 2, 4), (1, 2, 4, 8))


def pd_gather(x, d, dilation: int):
    """Pitch-dependent past and future taps ``x[t -+ D(t)]`` of ``(B, T,
    C)``, ``D = round(d * dilation)`` (halves to even, as ``jnp.rint``)
    from the dilation factors ``d`` ``(B, T)``, indices clamped to the
    sequence (its edge samples repeat)."""
    t = x.shape[1]
    shift = torch.round(d.float() * dilation).long()
    pos = torch.arange(t, device=x.device)
    past = torch.clamp(pos - shift, 0, t - 1)
    future = torch.clamp(pos + shift, 0, t - 1)
    c = x.shape[-1]
    return (torch.gather(x, 1, past[..., None].expand(-1, -1, c)),
            torch.gather(x, 1, future[..., None].expand(-1, -1, c)))


def pitch_dependent_conv(x, d, kernels, bias, dilation: int):
    """A k = 3 conv whose taps sit at t - D(t), t and t + D(t); ``kernels``
    ``(3, C, Cout)`` ordered past, current, future (the package's three
    1x1 convs)."""
    x_p, x_f = pd_gather(x, d, dilation)
    y = x_p @ kernels[0] + x @ kernels[1] + x_f @ kernels[2]
    return y if bias is None else y + bias


class QPResidualBlock(nn.Module):
    """Quasi-periodic residual block: per dilation, h = LReLU(x); y =
    convC(h) + convP(h[t - D]) + convF(h[t + D]); [y = convA(LReLU(y))];
    x = x + y (the package's AdaptiveResidualBlock)."""

    def __init__(self, channels: int, dilations: Sequence[int],
                 kernel_size: int = 3, use_additional_convs: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("the pitch-dependent conv has kernel size 3")
        self.dilations = tuple(dilations)
        self.use_additional_convs = use_additional_convs
        for i in range(len(self.dilations)):
            for tap in "CPF":
                setattr(self, f"conv{tap}{i}",
                        Conv1d(channels, channels, 1, dtype=dtype))
            if use_additional_convs:
                setattr(self, f"convA{i}",
                        Conv1d(channels, channels, 3, dtype=dtype))

    def forward(self, x, d):
        for i, dil in enumerate(self.dilations):
            h = leaky_relu_01(x)
            h_p, h_f = pd_gather(h, d, dil)
            y = (getattr(self, f"convC{i}")(h)
                 + getattr(self, f"convP{i}")(h_p)
                 + getattr(self, f"convF{i}")(h_f))
            if self.use_additional_convs:
                y = getattr(self, f"convA{i}")(leaky_relu_01(y))
            x = x + y
        return x


class SiFiGANGenerator(nn.Module):
    """The SiFiGAN generator; ``direct`` (``SiFiGANDirectGenerator``)
    conditions the filter network on the excitation signal instead of the
    source network's features."""

    direct = False

    def __init__(self, in_channels: int = 43, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Tuple[int, ...] = (5, 4, 3, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (10, 8, 6, 4),
                 source_resblock_kernel_size: int = 3,
                 source_resblock_dilations=SOURCE_DILATIONS,
                 source_use_additional_convs: bool = True,
                 filter_resblock_kernel_sizes: Tuple[int, ...] = (3, 5, 7),
                 filter_resblock_dilations=((1, 3, 5),) * 3,
                 filter_use_additional_convs: bool = False,
                 share_upsamples: bool = False,
                 share_downsamples: bool = False, dtype=torch.float32,
                 resblock_backend: str = "fused"):
        super().__init__()
        if self.direct and share_downsamples:
            raise ValueError("the Direct generator's filter downsamples "
                             "embed the excitation: none is shared")
        self.dtype = as_dtype(dtype)
        self.upsample_scales = tuple(upsample_scales)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.source_resblock_dilations = tuple(
            tuple(d) for d in source_resblock_dilations)
        self.source_use_additional_convs = source_use_additional_convs
        self.filter_resblock_kernel_sizes = tuple(filter_resblock_kernel_sizes)
        self.filter_resblock_dilations = tuple(
            tuple(d) for d in filter_resblock_dilations)
        self.filter_use_additional_convs = filter_use_additional_convs
        self.share_upsamples = share_upsamples
        self.share_downsamples = share_downsamples
        n_up = len(self.upsample_scales)
        k = kernel_size
        self.input_conv = Conv1d(in_channels, channels, k, dtype=dtype)
        for i, (s, k_up) in enumerate(zip(self.upsample_scales,
                                          self.upsample_kernel_sizes)):
            for tag in ("sn",) if share_upsamples else ("sn", "fn"):
                setattr(self, f"{tag}_up{i}", ConvTranspose1d(
                    channels // 2 ** i, channels // 2 ** (i + 1), k_up,
                    stride=s, padding=s // 2 + s % 2, output_padding=s % 2,
                    dtype=dtype))
            ch = channels // 2 ** (i + 1)
            setattr(self, f"sn_block{i}", QPResidualBlock(
                ch, self.source_resblock_dilations[i],
                source_resblock_kernel_size, source_use_additional_convs,
                dtype=dtype))
            for j, (k_res, dils) in enumerate(zip(
                    self.filter_resblock_kernel_sizes,
                    self.filter_resblock_dilations)):
                setattr(self, f"fn_block{i}_{j}", HiFiGANResidualBlock(
                    k_res, ch, dils, filter_use_additional_convs,
                    dtype=dtype, backend=resblock_backend))
        # downsamples[i] runs at level n_up - 1 - i's geometry: the stride
        # and kernel of the mirrored upsample, channels doubling
        for i in range(n_up - 1):
            j = n_up - 1 - i
            s = self.upsample_scales[j]
            for tag in ("sn",) if share_downsamples else ("sn", "fn"):
                setattr(self, f"{tag}_down{i}", Conv1d(
                    channels // 2 ** (j + 1), channels // 2 ** j,
                    self.upsample_kernel_sizes[j], stride=s,
                    padding=s // 2 + s % 2, dtype=dtype))
        finest = channels // 2 ** n_up
        self.sn_emb = Conv1d(1, finest, k, dtype=dtype)
        if self.direct:
            self.fn_emb = Conv1d(out_channels, finest, k, dtype=dtype)
        self.sn_output_conv = Conv1d(finest, out_channels, k, dtype=dtype)
        self.fn_output_conv = Conv1d(finest, out_channels, k, dtype=dtype)

    def _module(self, tag: str, kind: str, i: int):
        shared = (self.share_upsamples if kind == "up"
                  else self.share_downsamples)
        return getattr(self, f"{'sn' if shared else tag}_{kind}{i}")

    def _pyramid(self, x, tag: str):
        """``x`` and its downsamplings by ``{tag}_down{i}``, finest first."""
        out = [x]
        for i in range(len(self.upsample_scales) - 1):
            x = leaky_relu_01(self._module(tag, "down", i)(x))
            out.append(x)
        return out

    def forward(self, sine, c, dfs):
        """Synthesize.

        Args:
            sine: ``(B, T_wav, 1)`` excitation at the waveform rate.
            c: ``(B, T_frames, in_channels)`` aux features.
            dfs: per level, ``(B, T_level)`` dense dilation factors.

        Returns:
            (waveform, excitation), each ``(B, T_frames * prod(scales),
            out_channels)``.
        """
        n_up = len(self.upsample_scales)
        h = self.input_conv(c.to(self.dtype))
        embs = self._pyramid(self.sn_emb(sine.to(self.dtype)), "sn")

        e = h
        for i in range(n_up):
            e = self._module("sn", "up", i)(leaky_relu_01(e))
            emb = embs[n_up - 1 - i]
            t = min(e.shape[1], emb.shape[1])
            e = e[:, :t] + emb[:, :t]
            e = getattr(self, f"sn_block{i}")(e, dfs[i][:, :t])
        excitation = self.sn_output_conv(e)

        fembs = self._pyramid(self.fn_emb(excitation) if self.direct else e,
                              "fn")
        x = h
        n_blocks = len(self.filter_resblock_kernel_sizes)
        for i in range(n_up):
            x = self._module("fn", "up", i)(leaky_relu_01(x))
            emb = fembs[n_up - 1 - i]
            t = min(x.shape[1], emb.shape[1])
            x = x[:, :t] + emb[:, :t]
            acc = None
            for j in range(n_blocks):
                hh = getattr(self, f"fn_block{i}_{j}")(x)
                acc = hh if acc is None else acc + hh
            x = acc / n_blocks
        x = self.fn_output_conv(leaky_relu_01(x))
        return torch.tanh(x), excitation


class SiFiGANDirectGenerator(SiFiGANGenerator):
    """SiFi-GAN Direct: the filter network embeds the source network's
    output excitation (``fn_emb``, waveform rate) and downsamples it with
    its own ``fn_down{i}``, instead of the source's hidden features (the
    paper's section 3.3 ablation; the vendored sifigan.direct.yaml)."""

    direct = True
