"""Plain reference of the served language model (grok-1's layer as the
port serves it, see the configuration's ``assumed``), in plain PyTorch
and float32, layer by layer over a few sequences at once, each weight
block widened to float32 only while it is used.

A layer: RMSNorm (gain 1 + g), grouped-query attention with rotary
positions over the causal prefix, the residual; RMSNorm, a softmax router
choosing the top ``k`` experts (ties: the lower index), their weights
renormalized, each expert a SiLU-gated MLP, the residual.  A prompt is
served as one prefill: its pairs of (token, choice) fill each expert's
``capacity`` slots in token order and the rest are dropped; each later
token is served alone and drops nothing.  Then a final RMSNorm and the
unembedding.

``fp8=True`` is the control: every product of a bfloat16 weight runs on
operands rounded to float8 (e4m3, a scale a weight matrix and a token
row), accumulated in float32; the float32 router is left as it is.
"""
from __future__ import annotations

import math

import torch


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float):
    """Slots an expert has in a prefill of ``n_tokens`` tokens: the
    pairs' fair share times ``factor``, up to a multiple of 4, at least
    4 and at most ``n_tokens``."""
    c = int(math.ceil(n_tokens * top_k / n_experts * factor))
    return max(4, min(n_tokens, -(-c // 4) * 4))


def _fp8(x, dim):
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    def __init__(self, params, cfg: dict, fp8: bool = False):
        self.p = params
        self.cfg = cfg
        self.fp8 = fp8
        self._miss = self._choices = 0

    def miss_share(self) -> float:
        """Of the (position, layer) choices the last ``forward`` followed,
        the share whose experts are not the reference's own top k."""
        return self._miss / self._choices if self._choices else 0.0

    def _w(self, w):
        """A weight block as the reference multiplies it."""
        w = w.float()
        return _fp8(w, None) if self.fp8 else w

    def _mm(self, x, w):
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w

    def _norm(self, x, g):
        eps = self.cfg["rms_norm_eps"]
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
            1.0 + g.float())

    def _rope(self, x, pos):
        D = x.shape[-1]
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, D, 2, device=x.device, dtype=torch.float32)
            / D))
        ang = pos[:, None].float() * inv
        ang = torch.cat([ang, ang], -1)[:, None, :]
        x1, x2 = x[..., :D // 2], x[..., D // 2:]
        return x * torch.cos(ang) + torch.cat([-x2, x1], -1) * torch.sin(ang)

    def _attend(self, q, k, v, block=1024):
        """Causal grouped-query attention: q (T, H, D), k/v (T, KV, D)."""
        T, H, D = q.shape
        KV = k.shape[1]
        G = H // KV
        qg = q.reshape(T, KV, G, D)
        out = []
        for s in range(0, T, block):
            qb = qg[s:s + block]
            sc = torch.einsum("tkgd,skd->kgts", qb, k) * D ** -0.5
            tq = torch.arange(s, s + qb.shape[0], device=q.device)
            mask = torch.arange(T, device=q.device)[None, :] <= tq[:, None]
            sc = torch.where(mask, sc, float("-inf"))
            pr = torch.softmax(sc, -1)
            out.append(torch.einsum("kgts,skd->tkgd", pr, v)
                       .reshape(qb.shape[0], H * D))
        return torch.cat(out)

    def forward(self, seqs, routing=None):
        """``seqs``: (tokens (L,) int64 tensor, prompt length P, scored
        positions) each.  ``routing``: for each sequence, a layer's
        (L, k) experts of every position (the program's own choices);
        None routes by the reference's own top k.  Returns, per
        sequence, the float32 logits at its scored positions, the
        widest routing gap (how far a chosen expert's router logit lies
        below the k-th best, over positions and layers), and the routing
        used; ``miss_share`` then gives the share of choices that were
        not the reference's own."""
        p, c = self.p, self.cfg
        H, KV, D = (c["num_attention_heads"], c["num_key_value_heads"],
                    c["head_dim"])
        k_top, E = c["num_experts_per_tok"], c["num_experts"]
        dev = p["embed"]["table"].device
        hs = [p["embed"]["table"][t.to(dev)].float() for t, _, _ in seqs]
        self._miss = self._choices = 0
        used = [[] for _ in seqs]
        rgap = [0.0 for _ in seqs]
        for li, layer in enumerate(p["stages"][0]["layers"]):
            m = layer["mixer"]
            wq, wk, wv, wo = (self._w(m[n]) for n in ("wq", "wk", "wv",
                                                      "wo"))
            for i, (tok, P, _) in enumerate(seqs):
                x = self._norm(hs[i], layer["mixer_norm"]["scale"])
                T = x.shape[0]
                pos = torch.arange(T, device=dev)
                q = self._rope(self._mm(x, wq).reshape(T, H, D), pos)
                kk = self._rope(self._mm(x, wk).reshape(T, KV, D), pos)
                vv = self._mm(x, wv).reshape(T, KV, D)
                hs[i] = hs[i] + self._mm(self._attend(q, kk, vv), wo)
            del wq, wk, wv, wo
            f = layer["ffn"]
            routed = []                     # (seq, tokens, weights, expert)
            xs = []
            for i, (tok, P, _) in enumerate(seqs):
                x = self._norm(hs[i], layer["ffn_norm"]["scale"])
                xs.append(x)
                logits = x @ f["router"]["w"].float()
                probs = torch.softmax(logits, -1)
                own = torch.sort(probs, dim=-1, descending=True,
                                 stable=True).indices[:, :k_top]
                e = own if routing is None else routing[i][li].to(dev).long()
                self._miss += int((e.sort(-1).values != own.sort(-1).values)
                                  .any(-1).sum())
                self._choices += e.shape[0]
                kth = torch.sort(logits, dim=-1, descending=True
                                 ).values[:, k_top - 1]
                rgap[i] = max(rgap[i], float(
                    (kth - logits.gather(1, e).min(-1).values).max()))
                used[i].append(e)
                w = probs.gather(1, e)
                w = w / w.sum(-1, keepdim=True)
                keep = torch.ones_like(e, dtype=torch.bool)
                C = capacity(P, k_top, E, c["capacity_factor"])
                ef = e[:P].reshape(-1)
                onehot = torch.nn.functional.one_hot(ef, E)
                rank = (torch.cumsum(onehot, 0) - 1).gather(
                    1, ef[:, None])[:, 0].reshape(P, k_top)
                keep[:P] = rank < C
                for j in range(k_top):
                    routed.append((i, torch.nonzero(keep[:, j])[:, 0],
                                   w[:, j], e[:, j]))
            outs = [torch.zeros_like(h) for h in hs]
            ex = f["experts"]
            for ei in range(E):
                wg, wu, wd = (self._w(ex[n][ei]) for n in
                              ("w_gate", "w_up", "w_down"))
                for i, t, w, e in routed:
                    t = t[e[t] == ei]
                    for s in range(0, len(t), 4096):
                        tb = t[s:s + 4096]
                        xb = xs[i][tb]
                        y = self._mm(torch.nn.functional.silu(
                            self._mm(xb, wg)) * self._mm(xb, wu), wd)
                        outs[i].index_add_(0, tb, y * w[tb, None])
                del wg, wu, wd
            hs = [h + o for h, o in zip(hs, outs)]
        logits = []
        un = p["unembed"]["w"]
        for i, (_, _, scored) in enumerate(seqs):
            x = self._norm(hs[i][scored], p["final_norm"]["scale"])
            cols = []
            for s in range(0, un.shape[1], 16384):
                cols.append(self._mm(x, self._w(un[:, s:s + 16384])))
            logits.append(torch.cat(cols, -1))
        return logits, rgap, used


def gaps(ref_logits, tokens):
    """How far each chosen token's reference logit lies below the
    reference's best, position by position."""
    t = torch.as_tensor(tokens, device=ref_logits.device)[:, None]
    return ref_logits.max(-1).values - ref_logits.gather(1, t)[:, 0]
