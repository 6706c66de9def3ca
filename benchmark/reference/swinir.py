"""Real-SwinIR (Liang et al., ICCVW 2021: SwinIR with the 'nearest+conv'
upsampler of its real_sr task) as plain float32 PyTorch, written from the
published equations in SwinIR's own layout (NCHW maps, [B, L, C] tokens,
window partition and ``torch.roll``). No departure from them.

- x - mean (RGB mean 0.4488, 0.4371, 0.4040; times ``img_range``), after a
  reflect pad of the bottom and right to a multiple of the window
  (``check_image_size``);
- conv_first 3x3; patch embed: flatten, LayerNorm;
- per RSTB: ``depth`` Swin blocks, unflatten, '3conv' (3x3 C -> C/4,
  LeakyReLU 0.2, 1x1, LeakyReLU 0.2, 3x3 C/4 -> C), flatten, plus the
  RSTB's input;
- a Swin block: ``x = x + proj(WA(LN1(x)))``, ``x = x + fc2(GELU(fc1(LN2(x))))``;
  WA splits the map into windows of ``window_size``^2 tokens (odd blocks
  after rolling it by -window/2, with ``calculate_mask``'s -100 between the
  shifted image's regions, rolled back after), ``softmax((q * head_dim^-0.5)
  k^T + B + mask) v`` per head, B the relative-position bias table at
  ``relative_position_index``;
- a final LayerNorm, unflatten, conv_after_body ('3conv') plus conv_first's
  output; conv_before_upsample 3x3 -> 64 with LeakyReLU 0.01; conv_up1 and
  conv_up2 each on a nearest-x2 map with LeakyReLU 0.2; conv_hr with
  LeakyReLU 0.2; conv_last; / img_range + mean; crop to 4H x 4W.

Weights are SwinIR's state dict by its published keys (float32 tensors);
LayerNorm eps 1e-5, GELU by erf. ``quant`` rounds the operands of every
product before it (each Linear's and conv's input and weight, q and k, the
softmax's output and v): the control one step below the configuration's
precision (``reference.precision.fp8``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = (0.4488, 0.4371, 0.4040)
EPS = 1e-5


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def forward(x: torch.Tensor, wts: dict, cfg: dict, quant=None) -> torch.Tensor:
    """``x`` [B, 3, H, W] float32 in 0..1 -> [B, 3, 4H, 4W]; ``wts`` the
    state dict; ``cfg`` SwinIR's settings (``embed_dim``, ``depths``,
    ``num_heads``, ``window_size``, ``img_range``)."""
    q = quant or (lambda t: t)
    ws, img_range = cfg["window_size"], cfg["img_range"]

    def linear(t, name):
        return F.linear(q(t), q(wts[name + ".weight"]), wts[name + ".bias"])

    def conv(t, name, pad):
        return F.conv2d(q(t), q(wts[name + ".weight"]), wts[name + ".bias"], padding=pad)

    def norm(t, name):
        return F.layer_norm(t, (t.shape[-1],), wts[name + ".weight"], wts[name + ".bias"], EPS)

    def three_conv(t, name):
        t = F.leaky_relu(conv(t, name + ".0", 1), 0.2)
        t = F.leaky_relu(conv(t, name + ".2", 0), 0.2)
        return conv(t, name + ".4", 1)

    H, W = x.shape[2:]
    x = F.pad(x, (0, (ws - W % ws) % ws, 0, (ws - H % ws) % ws), "reflect")
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * img_range
    x = conv(x, "conv_first", 1)
    b, c, h, w = x.shape
    index = relative_position_index(ws).to(x.device)

    def attention(t, name, heads, mask):
        bw, n, _ = t.shape
        qkv = linear(t, name + ".qkv").reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        qq, kk, vv = qkv[0], qkv[1], qkv[2]
        qq = qq * (c // heads) ** -0.5
        attn = q(qq) @ q(kk).transpose(-2, -1)
        table = wts[name + ".relative_position_bias_table"]
        attn = attn + table[index.view(-1)].view(n, n, -1).permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (q(attn) @ q(vv)).transpose(1, 2).reshape(bw, n, c)
        return linear(out, name + ".proj")

    def block(t, name, heads, shift):
        shortcut = t
        t = norm(t, name + ".norm1").view(b, h, w, c)
        if shift:
            t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
        win = window_partition(t, ws).view(-1, ws * ws, c)
        mask = calculate_mask(h, w, ws, shift, x.device) if shift else None
        win = attention(win, name + ".attn", heads, mask).view(-1, ws, ws, c)
        t = window_reverse(win, ws, h, w)
        if shift:
            t = torch.roll(t, shifts=(shift, shift), dims=(1, 2))
        t = shortcut + t.view(b, h * w, c)
        y = linear(F.gelu(linear(norm(t, name + ".norm2"), name + ".mlp.fc1")), name + ".mlp.fc2")
        return t + y

    def unembed(t):
        return t.transpose(1, 2).view(b, c, h, w)

    t = norm(x.flatten(2).transpose(1, 2), "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        rstb_in = t
        for j in range(depth):
            t = block(t, f"layers.{i}.residual_group.blocks.{j}", heads, 0 if j % 2 == 0 else ws // 2)
        t = three_conv(unembed(t), f"layers.{i}.conv").flatten(2).transpose(1, 2) + rstb_in
    t = unembed(norm(t, "norm"))
    x = three_conv(t, "conv_after_body") + x
    x = F.leaky_relu(conv(x, "conv_before_upsample.0", 1), 0.01)
    x = F.leaky_relu(conv(F.interpolate(x, scale_factor=2, mode="nearest"), "conv_up1", 1), 0.2)
    x = F.leaky_relu(conv(F.interpolate(x, scale_factor=2, mode="nearest"), "conv_up2", 1), 0.2)
    x = conv(F.leaky_relu(conv(x, "conv_hr", 1), 0.2), "conv_last", 1)
    x = x / img_range + mean
    return x[:, :, : H * 4, : W * 4]
