"""Analytic work counts from shapes: the multiply-adds of every
convolution, linear layer and attention product (two operations each),
without normalisations, activations and additions, as MFU is counted.

The configurations are the dicts of ``configs/*.json``. Counts are of the
useful work: the CFG-unconditional rows of the stage-2 / stage-3 UNet see
an all-zero context, so their cross-attention is a constant (the output
projection's bias) and ``cross_rows`` leaves it out.
"""

from __future__ import annotations


def conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """One image through a k x k convolution with an h x w output."""
    return 2 * cin * cout * k * k * h * w


def linear(fin: int, fout: int, rows: int) -> int:
    return 2 * fin * fout * rows


def attention(bh: int, lq: int, lk: int, d: int) -> int:
    """q k^T and p v: 4 * B*H * Lq * Lk * d."""
    return 4 * bh * lq * lk * d


def attention_bytes(bh: int, lq: int, lk: int, d: int,
                    elem: int = 2) -> int:
    """q, k, v read once and o written once."""
    return elem * bh * d * (2 * lq + 2 * lk)


def attention_train(bh: int, lq: int, lk: int, d: int) -> int:
    """Forward and backward of one call, the work the function needs with
    the scores recomputed once: q k^T and p v (4), then q k^T again, dv =
    p^T do, dp = do v^T, dq = ds k and dk = ds^T q (10), times
    B*H * Lq * Lk * d, as PyTorch's flop counter counts SDPA. A backward
    split into a dq and a dk / dv kernel that each recompute the scores and
    dp does 18; the 4 more are the split's cost and not counted."""
    return 14 * bh * lq * lk * d


def attention_train_bytes(bh: int, lq: int, lk: int, d: int,
                          elem: int = 2) -> int:
    """q, k, v, o and do read once, dq, dk and dv written once, and the
    row statistics (f32) once each way."""
    return elem * bh * d * (4 * lq + 4 * lk) + 2 * 4 * bh * lq


def _resnet(cin, cout, h, w, temb=None):
    f = conv(cin, cout, 3, h, w) + conv(cout, cout, 3, h, w)
    if cin != cout:
        f += conv(cin, cout, 1, h, w)
    if temb is not None:
        f += linear(temb, cout, 1)
    return f


def _transformer(c, n, ctx_len, ctx_dim, head_dim, rows, cross_rows):
    """Per-image self part times ``rows`` plus the cross-attention part
    times ``cross_rows``."""
    self_part = (4 * linear(c, c, n)                    # proj_in / out, q, o
                 + 2 * linear(c, c, n)                  # k, v
                 + attention(c // head_dim, n, n, head_dim)
                 + linear(c, 8 * c, n) + linear(4 * c, c, n))
    cross = (2 * linear(c, c, n) + 2 * linear(ctx_dim, c, ctx_len)
             + attention(c // head_dim, n, ctx_len, head_dim))
    return rows * self_part + cross_rows * cross


def unet(cfg: dict, batch: int, lh: int, lw: int, ctx_len: int,
         cross_rows: int = None) -> int:
    """One forward of the SD UNet over ``batch`` latents of lh x lw."""
    cross_rows = batch if cross_rows is None else cross_rows
    ch = cfg["block_out_channels"]
    n, lpb = len(ch), cfg["layers_per_block"]
    hd, cd = cfg["attention_head_dim"], cfg["cross_attention_dim"]
    cross = cfg["cross_attn_down"]
    temb = 4 * ch[0]

    def tr(c, hw):
        return _transformer(c, hw, ctx_len, cd, hd, batch, cross_rows)

    f = batch * (linear(ch[0], temb, 1) + linear(temb, temb, 1))
    if cfg.get("class_embed_proj_dim"):
        f += batch * (linear(cfg["class_embed_proj_dim"], temb, 1)
                      + linear(temb, temb, 1))
    h, w = lh, lw
    f += batch * conv(cfg["in_channels"], ch[0], 3, h, w)
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(lpb):
            f += batch * _resnet(cin, cout, h, w, temb)
            if cross[i]:
                f += tr(cout, h * w)
            cin = cout
        if i < n - 1:
            h, w = h // 2, w // 2
            f += batch * conv(cout, cout, 3, h, w)
    f += batch * 2 * _resnet(ch[-1], ch[-1], h, w, temb) + tr(ch[-1], h * w)
    rev = list(reversed(ch))
    prev = rev[0]
    for i in range(n):
        skip_ch = rev[min(i + 1, n - 1)]
        for j in range(lpb + 1):
            cin = ((prev if j == 0 else rev[i])
                   + (skip_ch if j == lpb else rev[i]))
            f += batch * _resnet(cin, rev[i], h, w, temb)
            if cross[n - 1 - i]:
                f += tr(rev[i], h * w)
        if i < n - 1:
            h, w = 2 * h, 2 * w
            f += batch * conv(rev[i], rev[i], 3, h, w)
        prev = rev[i]
    return f + batch * conv(ch[0], cfg["out_channels"], 3, h, w)


def _vae_mid(c, h, w):
    n = h * w
    return (2 * _resnet(c, c, h, w) + 4 * linear(c, c, n)
            + attention(1, n, n, c))


def vae_encode(cfg: dict, batch: int, height: int, width: int) -> int:
    ch, lpb = cfg["block_out_channels"], cfg["layers_per_block"]
    lat = cfg["latent_channels"]
    h, w = height, width
    f = conv(cfg["in_channels"], ch[0], 3, h, w)
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(lpb):
            f += _resnet(cin if j == 0 else cout, cout, h, w)
        cin = cout
        if i < len(ch) - 1:
            h, w = h // 2, w // 2
            f += conv(cout, cout, 3, h, w)
    f += _vae_mid(ch[-1], h, w) + conv(ch[-1], 2 * lat, 3, h, w)
    f += conv(2 * lat, 2 * lat, 1, h, w)
    return batch * f


def vae_decode(cfg: dict, batch: int, lh: int, lw: int) -> int:
    ch, lpb = cfg["block_out_channels"], cfg["layers_per_block"]
    lat = cfg["latent_channels"]
    rev = list(reversed(ch))
    h, w = lh, lw
    f = conv(lat, lat, 1, h, w) + conv(lat, rev[0], 3, h, w)
    f += _vae_mid(rev[0], h, w)
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(lpb + 1):
            f += _resnet(cin if j == 0 else cout, cout, h, w)
        cin = cout
        if i < len(rev) - 1:
            h, w = 2 * h, 2 * w
            f += conv(cout, cout, 3, h, w)
    f += conv(rev[-1], cfg["in_channels"], 3, h, w)
    return batch * f


def image_proj(cfg: dict, batch: int, tokens: int) -> int:
    return batch * (linear(cfg["in_dim"], cfg["hidden_dim"], tokens)
                    + linear(cfg["hidden_dim"], cfg["out_dim"], tokens))


def pose_proj(cfg: dict, batch: int, height: int, width: int) -> int:
    ch = cfg["block_out_channels"]
    h, w = height, width
    f = conv(3, ch[0], 3, h, w)
    for a, b in zip(ch[:-1], ch[1:]):
        f += conv(a, a, 3, h, w)
        h, w = h // 2, w // 2
        f += conv(a, b, 3, h, w)
    return batch * (f + conv(ch[-1], cfg["out_channels"], 3, h, w))


def roofline_seconds(flops: float, nbytes: float, peak_flops: float,
                     peak_bytes: float) -> float:
    """The least time a call can take: the larger of its two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)
