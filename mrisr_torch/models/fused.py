"""Fused ControlNet+UNet encoder towers (port of ``mrisr_tpu/models/fused.py``), NCHW.

The ControlNet is a copy of the UNet's down and mid tower (``conv_in``,
``time_embedding``, ``down_blocks_i``, ``mid_block``: same classes, same
names), and the two towers are independent: the ControlNet's zero-conv
residuals join the UNet only after its down tower and after its mid block.
So both towers can run as one program over two lanes, lane 0 the UNet's
weights and lane 1 the ControlNet's.  The reference vmaps one tower over
weights stacked on a new axis.  Here the two lanes run as one set of
launches instead:

* activations hold the lanes on the channel axis, ``[B, 2C, H, W]`` (lane 0
  the first C channels), and each conv is one ``groups=2`` conv with the two
  weights concatenated along the output channels (``conv_in``, whose input
  both lanes share, is one plain conv);
* each GroupNorm+SiLU head is one launch of the fused kernel over 2G groups
  with the two affines concatenated (a group never straddles the lanes), and
  the transformers' plain GroupNorms likewise;
* inside a transformer the tokens are ``[2, B*N, C]``: each Linear is one
  batched product over the lane axis, each LayerNorm runs per lane, and
  attention folds the lanes into the batch (``[2B, N, C]``), so the
  flash-attention kernel sees both lanes' images and heads in one launch.

:func:`stack_tower_params` concatenates (convs, norms) or stacks (Linears,
LayerNorms) the two towers' shared parameters.  Callers stack inside the
chain or the training step, not once at construction, so weights changed in
place (a LoRA merge, a checkpoint copied in) are seen by the next call and,
in a training step, the gradient reaches the ControlNet lane through the
concatenation.  The math is the unfused path's (``pipelines/latent.py``'s
step with ``fused_towers=False``); the lanes only change how it is batched.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mrisr_torch.models.sd_layers import _promote, attend
from mrisr_torch.models.sd_unet import SDUNet
from mrisr_torch.ops.groupnorm import group_norm_silu

LANES = 2  # lane 0 the UNet, lane 1 the ControlNet
FUSED_ATTRS = ("block_out_channels", "layers_per_block", "heads", "context_dim")


def shared_tower_keys(n_blocks: int) -> list[str]:
    """The top-level submodules (parameter-name prefixes) the SDUNet and the ControlNet share one for one."""
    return ["conv_in", "time_embedding", "mid_block"] + [f"down_blocks_{i}" for i in range(n_blocks)]


def check_fusable(unet, controlnet) -> None:
    """Raise ``ValueError`` unless the two encoder configurations coincide (they do for a ControlNet built from
    the UNet, the only kind the reference's path makes)."""
    for attr in FUSED_ATTRS:
        a, b = getattr(unet, attr), getattr(controlnet, attr)
        norm = lambda v: tuple(v) if isinstance(v, (tuple, list)) else v  # noqa: E731
        if norm(a) != norm(b):
            raise ValueError(f"fused towers need matching UNet/ControlNet configs; {attr}: unet={a} controlnet={b}")


def resolve_fused(fused: bool | None, unet, controlnet) -> bool:
    """The reference's rule: ``None`` fuses when :func:`check_fusable` passes; ``True`` requires it."""
    if fused is None:
        try:
            check_fusable(unet, controlnet)
        except ValueError:
            return False
        return True
    if fused:
        check_fusable(unet, controlnet)
    return bool(fused)


def stack_tower_params(unet: SDUNet, unet_params: dict[str, torch.Tensor],
                       cn_params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The shared encoder parameters of both towers, by the UNet's parameter names: conv and GroupNorm
    parameters concatenated along dim 0 (lane 0 first), Linear and LayerNorm parameters stacked on a new
    dim 0 of size 2.  ``unet_params`` and ``cn_params`` are ``name -> tensor`` dicts (``named_parameters``,
    or the parameters a functional step differentiates)."""
    keys = set(shared_tower_keys(len(unet.block_out_channels)))
    out = {}
    for name, p in unet_params.items():
        if name.split(".", 1)[0] not in keys:
            continue
        owner = unet.get_submodule(name.rsplit(".", 1)[0])
        join = torch.stack if isinstance(owner, (nn.Linear, nn.LayerNorm)) else torch.cat
        out[name] = join([p, cn_params[name]])
    return out


# ---------------------------------------------------------------------------
# Layers over the two lanes (``s``: the stacked parameters; ``m``: the UNet's module, for its configuration)
# ---------------------------------------------------------------------------


def _conv(s, m: nn.Conv2d, p: str, x: torch.Tensor, groups: int = LANES) -> torch.Tensor:
    x, w, b = _promote(x, s[f"{p}.weight"], s.get(f"{p}.bias"))
    return F.conv2d(x, w, b, m.stride, m.padding, m.dilation, groups)


def _gn_silu(s, norm: nn.GroupNorm, p: str, x: torch.Tensor) -> torch.Tensor:
    return group_norm_silu(*_promote(x, s[f"{p}.weight"], s[f"{p}.bias"]), LANES * norm.num_groups, norm.eps)


def _group_norm(s, norm: nn.GroupNorm, p: str, x: torch.Tensor) -> torch.Tensor:
    x, w, b = _promote(x, s[f"{p}.weight"], s[f"{p}.bias"])
    return torch.group_norm(x, LANES * norm.num_groups, w, b, norm.eps)


def _linear(s, p: str, x: torch.Tensor) -> torch.Tensor:
    """``x [2, M, in]`` through each lane's Linear: ``[2, M, out]``."""
    x, w, b = _promote(x, s[f"{p}.weight"], s.get(f"{p}.bias"))
    wt = w.transpose(1, 2)
    return torch.bmm(x, wt) if b is None else torch.baddbmm(b[:, None, :], x, wt)


def _layer_norm(s, norm: nn.LayerNorm, p: str, x: torch.Tensor) -> torch.Tensor:
    x, w, b = _promote(x, s[f"{p}.weight"], s[f"{p}.bias"])
    return torch.stack([F.layer_norm(x[i], norm.normalized_shape, w[i], b[i], norm.eps) for i in range(LANES)])


def _attention(s, a, p: str, x: torch.Tensor, ctx: torch.Tensor | None, b: int) -> torch.Tensor:
    """``x [2, B*N, C]``, self-attention or cross-attention to ``ctx [2, B*L, Cc]``; the lanes fold into the
    batch for the attention itself."""
    c = x if ctx is None else ctx
    q, k, v = _linear(s, f"{p}.to_q", x), _linear(s, f"{p}.to_k", c), _linear(s, f"{p}.to_v", c)
    inner = q.shape[-1]
    fold = lambda t: t.reshape(LANES * b, -1, inner)  # noqa: E731
    out = attend(fold(q), fold(k), fold(v), a.heads, a.head_dim)
    return _linear(s, f"{p}.to_out", out.reshape(LANES, -1, inner))


def _transformer_block(s, blk, p: str, x: torch.Tensor, ctx: torch.Tensor, b: int) -> torch.Tensor:
    x = x + _attention(s, blk.attn1, f"{p}.attn1", _layer_norm(s, blk.norm1, f"{p}.norm1", x), None, b)
    x = x + _attention(s, blk.attn2, f"{p}.attn2", _layer_norm(s, blk.norm2, f"{p}.norm2", x), ctx, b)
    h, gate = _linear(s, f"{p}.ff.net_0.proj", _layer_norm(s, blk.norm3, f"{p}.norm3", x)).chunk(2, dim=-1)
    return x + _linear(s, f"{p}.ff.net_2", h * F.gelu(gate, approximate="tanh"))


def _transformer(s, t, p: str, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    b, c2, h, w = x.shape
    c = c2 // LANES
    y = _conv(s, t.proj_in, f"{p}.proj_in", _group_norm(s, t.norm, f"{p}.norm", x))
    y = y.view(b, LANES, c, h * w).permute(1, 0, 3, 2).reshape(LANES, b * h * w, c)
    for i in range(t.depth):
        y = _transformer_block(s, getattr(t, f"transformer_blocks_{i}"), f"{p}.transformer_blocks_{i}", y, ctx, b)
    y = y.view(LANES, b, h * w, c).permute(1, 0, 3, 2).reshape(b, c2, h, w)
    return _conv(s, t.proj_out, f"{p}.proj_out", y) + x


def _resnet(s, r, p: str, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    """``temb [2, B, T]``, each lane's time embedding."""
    h = _conv(s, r.conv1, f"{p}.conv1", _gn_silu(s, r.norm1, f"{p}.norm1", x))
    if hasattr(r, "time_emb_proj"):
        e = _linear(s, f"{p}.time_emb_proj", F.silu(temb))  # [2, B, C]
        h = h + e.permute(1, 0, 2).reshape(x.shape[0], -1)[:, :, None, None]
    h = _conv(s, r.conv2, f"{p}.conv2", _gn_silu(s, r.norm2, f"{p}.norm2", h))
    if hasattr(r, "conv_shortcut"):
        x = _conv(s, r.conv_shortcut, f"{p}.conv_shortcut", x)
    return x + h


class DownMidTower:
    """The encoder half common to the SDUNet and the ControlNet, over both lanes (structure from ``unet``,
    weights from :func:`stack_tower_params`).

    ``tower(stacked, x, t, context, post_conv_add) -> (h, skips, temb)``:
    ``h`` and each skip ``[B, 2C, h, w]`` with lane 0 the UNet's channels,
    ``temb [2, B, 4 C0]``.  ``post_conv_add`` (the ControlNet's condition
    embedding, computed once a chain) is added to lane 1 right after
    ``conv_in``; lane 0 gets nothing, as the reference adds it zeros.
    """

    def __init__(self, unet: SDUNet):
        self.unet = unet

    def __call__(self, s: dict, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                 post_conv_add: torch.Tensor):
        u = self.unet
        n = len(u.block_out_channels)
        tp = u.time_proj(t)[None].expand(LANES, -1, -1)
        temb = _linear(s, "time_embedding.linear_2", F.silu(_linear(s, "time_embedding.linear_1", tp))).to(x.dtype)
        ctx = context.reshape(1, -1, context.shape[-1]).expand(LANES, -1, -1)  # [2, B*L, Cc], shared
        h = _conv(s, u.conv_in, "conv_in", x, groups=1)
        c0 = h.shape[1] // LANES
        h = torch.cat([h[:, :c0], h[:, c0:] + post_conv_add], dim=1)
        skips = [h]
        for i in range(n):
            block, p = getattr(u, f"down_blocks_{i}"), f"down_blocks_{i}"
            for j in range(block.layers):
                h = _resnet(s, getattr(block, f"resnets_{j}"), f"{p}.resnets_{j}", h, temb)
                if hasattr(block, f"attentions_{j}"):
                    h = _transformer(s, getattr(block, f"attentions_{j}"), f"{p}.attentions_{j}", h, ctx)
                skips.append(h)
            if hasattr(block, "downsamplers_0"):
                h = _conv(s, block.downsamplers_0.conv, f"{p}.downsamplers_0.conv", h)
                skips.append(h)
        mid = u.mid_block
        h = _resnet(s, mid.resnets_0, "mid_block.resnets_0", h, temb)
        h = _transformer(s, mid.attentions_0, "mid_block.attentions_0", h, ctx)
        h = _resnet(s, mid.resnets_1, "mid_block.resnets_1", h, temb)
        return h, skips, temb


class UNetUpTower(nn.Module):
    """The SDUNet's decode half (``SDUNet.up_tower``) as a module's forward, so ``functional_call`` can run it
    on other weights (a LoRA-merged UNet's)."""

    def __init__(self, unet: SDUNet):
        super().__init__()
        self.unet = unet

    def forward(self, h, skips, temb, context):
        return self.unet.up_tower(h, skips, temb, context)


def _zero_conv(cn_params: dict, name: str, x: torch.Tensor, scale: float) -> torch.Tensor:
    return F.conv2d(*_promote(x, cn_params[f"{name}.weight"], cn_params[f"{name}.bias"])) * scale


def _lane(x: torch.Tensor, i: int) -> torch.Tensor:
    c = x.shape[1] // LANES
    return x[:, i * c : (i + 1) * c]


def fused_eps(unet: SDUNet, controlnet, stacked: dict, x_t: torch.Tensor, t: torch.Tensor,
              context: torch.Tensor, cond_embedding: torch.Tensor, unet_params: dict | None = None,
              cn_params: dict | None = None) -> torch.Tensor:
    """One ε-prediction: the fused encoder over both lanes, the ControlNet's zero-conv residuals joined into
    the UNet lane's skips and mid output, then the UNet's decode.  ``unet_params`` / ``cn_params`` (``name ->
    tensor``) replace the modules' own parameters where given; ``stacked`` must be made from the same
    ones."""
    h, skips, temb = DownMidTower(unet)(stacked, x_t, t, context, cond_embedding)
    cp = dict(controlnet.named_parameters()) if cn_params is None else cn_params
    scale = controlnet.conditioning_scale
    skips = [_lane(sk, 0) + _zero_conv(cp, f"controlnet_down_blocks_{i}", _lane(sk, 1), scale)
             for i, sk in enumerate(skips)]
    h = _lane(h, 0) + _zero_conv(cp, "controlnet_mid_block", _lane(h, 1), scale)
    if unet_params is None:
        return unet.up_tower(h, skips, temb[0], context)
    return functional_call(UNetUpTower(unet), {f"unet.{k}": v for k, v in unet_params.items()},
                           (h, skips, temb[0], context))
