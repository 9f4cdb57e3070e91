"""Plain reference of DeepSeek-V3's layers as the cell serves them: one
card's share of an expert-parallel deployment, in plain PyTorch and
float32, layer by layer over a few sequences at once, each weight block
widened to float32 only while it is used.  It reads the program's
parameter tree (``params["stages"][i]["layers"]``) and the
configuration file's published keys; it imports nothing of the program.

A layer, from the published description (arXiv 2412.19437, the model's
``config.json``):

* RMSNorm, then multi-head latent attention in its expanded form: the
  query through its low-rank pair (``wq_a``, RMSNorm, ``wq_b``), split
  into a 128-wide part without position and a 64-wide rotary part; the
  latent ``wkv_a`` gives the 512-wide compressed KV (RMSNorm) and one
  64-wide rotary key shared by every head; each head's key is its
  ``wk_b`` expansion of the latent beside the shared rotary key, its
  value the ``wv_b`` expansion; causal softmax attention at scale
  ``192 ** -0.5 * mscale ** 2``; ``wo``; the residual.
* Rotary positions by YaRN: each pair's frequency ``theta ** -(2i/64)``
  blended with the same over ``factor`` by the linear ramp between the
  correction dims of ``beta_fast`` and ``beta_slow`` rotations over
  ``original_max_position_embeddings``; cos and sin times ``mscale /
  mscale_all_dim`` (1 here).
* RMSNorm, then the first ``first_k_dense_replace`` layers a SiLU-gated
  MLP of width ``intermediate_size``; the others the MoE: the router's
  sigmoid scores over all ``published_n_routed_experts`` experts (float32),
  the choice score = score + correction bias, the ``topk_group`` best of
  ``n_group`` groups by the sum of each group's two best choice scores
  (ties to the lower index), the top ``num_experts_per_tok`` choice
  scores inside them, weights = the scores (not the choice scores) at
  the chosen experts over their sum, times ``routed_scaling_factor``.
  Each expert is a SiLU-gated MLP of width ``moe_intermediate_size``.
  Only the experts this card holds (``n_routed_experts`` of them from
  ``expert_parallel.first_expert``) add their part, as the deployment's
  card computes it; then the shared expert, the residual.
* The final RMSNorm and the unembedding.

A prompt is served as one prefill: its (token, choice) pairs of a held
expert fill that expert's ``capacity`` slots in token order and the rest
are dropped, as the program drops; each later token is served alone and
drops nothing.

Departures from the published model, all the program's layout or the
cell's deployment (the configuration's ``assumed``): the RMSNorm gains
are stored zero-centred (gain ``1 + g``); the rotary pairs are the two
halves of the 64 dims, not the published interleave (a fixed permutation
of the random weights' rows); the experts other cards hold are left out
of the result; capacity drops over a prefill.

``fp8=True`` is the control: every product of a bfloat16 weight runs on
operands rounded to float8 (e4m3, a scale a weight matrix and a token
row), accumulated in float32; the float32 router is left as it is.
"""
from __future__ import annotations

import math

import torch

from .llm import _fp8, capacity


def yarn_inv_freq(cfg: dict, dim: int, device=None):
    """The rotary frequencies of a ``dim``-wide rotary part under the
    configuration's YaRN ``rope_scaling``."""
    y, theta = cfg["rope_scaling"], float(cfg["rope_theta"])
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (y["factor"] * theta ** exps)

    def corr_dim(rot):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr_dim(y["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_factor(cfg: dict) -> float:
    """The factor on cos and sin: ``mscale`` over ``mscale_all_dim``'s."""
    y = cfg["rope_scaling"]
    return (yarn_mscale(y["factor"], y["mscale"])
            / yarn_mscale(y["factor"], y["mscale_all_dim"]))


def softmax_scale(cfg: dict) -> float:
    y = cfg["rope_scaling"]
    m = yarn_mscale(y["factor"], y["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def experts_held(cfg: dict):
    """(first id, count) of the routed experts this card holds."""
    return cfg["expert_parallel"]["first_expert"], cfg["n_routed_experts"]


def group_choice(choice, cfg: dict):
    """The published top k of ``choice`` (T, E): the ``topk_group`` best
    groups by their two best choice scores, the top k inside them.
    Returns (experts (T, k), every group's score (T, n_group))."""
    T, E = choice.shape
    G = cfg["n_group"]
    grouped = choice.reshape(T, G, E // G)
    gscore = torch.sort(grouped, dim=-1, descending=True,
                        stable=True).values[..., :2].sum(-1)
    best = torch.sort(gscore, dim=-1, descending=True,
                      stable=True).indices[:, :cfg["topk_group"]]
    keep = torch.zeros((T, G), dtype=torch.bool, device=choice.device)
    keep.scatter_(1, best, True)
    masked = torch.where(keep[:, :, None], grouped, float("-inf"))
    idx = torch.sort(masked.reshape(T, E), dim=-1, descending=True,
                     stable=True).indices[:, :cfg["num_experts_per_tok"]]
    return idx, gscore


def routing_gaps(choice, gscore, e, cfg: dict):
    """For followed experts ``e`` (T, k): how far a chosen group's score
    lies below the reference's ``topk_group``-th best group, and how far
    a chosen expert's choice score lies below the reference's k-th best
    inside the chosen groups; the wider, position by position."""
    T, E = choice.shape
    G, k = cfg["n_group"], cfg["num_experts_per_tok"]
    per = E // G
    kth_group = torch.sort(gscore, -1, descending=True).values[
        :, cfg["topk_group"] - 1]
    groups = torch.div(e, per, rounding_mode="floor")
    g_gap = kth_group - gscore.gather(1, groups).min(-1).values
    chosen = torch.zeros((T, G), dtype=torch.bool, device=e.device)
    chosen.scatter_(1, groups, True)
    inside = torch.where(chosen.repeat_interleave(per, 1), choice,
                         float("-inf"))
    kth = torch.sort(inside, -1, descending=True).values[:, k - 1]
    e_gap = kth - choice.gather(1, e).min(-1).values
    return torch.maximum(g_gap, e_gap)


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
        return x @ self._w(w)

    def _norm(self, x, g):
        eps = self.cfg["rms_norm_eps"]
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
            1.0 + g.float())

    def _rope(self, x, inv):
        """x (T, heads, D) at positions 0..T-1, the two halves rotated."""
        T, _, D = x.shape
        ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
            * inv
        ang = torch.cat([ang, ang], -1)[:, None, :]
        x1, x2 = x[..., :D // 2], x[..., D // 2:]
        f = rope_factor(self.cfg)
        return (x * (torch.cos(ang) * f)
                + torch.cat([-x2, x1], -1) * (torch.sin(ang) * f))

    def _mla(self, m, x, inv, block=512):
        c = self.cfg
        T = x.shape[0]
        H, nope, rope, vd, r = (c["num_attention_heads"],
                                c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                                c["v_head_dim"], c["kv_lora_rank"])
        q = self._mm(self._norm(self._mm(x, m["wq_a"]), m["q_norm"]["scale"]),
                     m["wq_b"]).reshape(T, H, nope + rope)
        q = torch.cat([q[..., :nope], self._rope(q[..., nope:], inv)], -1)
        kv = self._mm(x, m["wkv_a"])
        ckv = self._norm(kv[:, :r], m["kv_norm"]["scale"])
        kpe = self._rope(kv[:, None, r:], inv)
        k = torch.cat([self._mm(ckv, m["wk_b"]).reshape(T, H, nope),
                       kpe.expand(T, H, rope)], -1)
        v = self._mm(ckv, m["wv_b"]).reshape(T, H, vd)
        scale = softmax_scale(c)
        out = []
        for s in range(0, T, block):
            qb = q[s:s + block]
            sc = torch.einsum("thd,shd->hts", qb, k) * scale
            tq = torch.arange(s, s + qb.shape[0], device=x.device)
            mask = torch.arange(T, device=x.device)[None, :] <= tq[:, None]
            sc = torch.where(mask, sc, float("-inf"))
            out.append(torch.einsum("hts,shd->thd", torch.softmax(sc, -1), v)
                       .reshape(qb.shape[0], H * vd))
        return self._mm(torch.cat(out), m["wo"])

    def _mlp(self, f, x):
        return self._mm(torch.nn.functional.silu(self._mm(x, f["wi_gate"]))
                        * self._mm(x, f["wi_up"]), f["wo"])

    def _route(self, f, x, given, P):
        """The router over one sequence: the experts it follows
        (``given``, else its own), their weights, their place in this
        card's share, which pairs a held expert keeps, and the widest
        routing gap."""
        c = self.cfg
        k, E = c["num_experts_per_tok"], c["published_n_routed_experts"]
        scores = torch.sigmoid(x @ f["router"]["w"].float())
        choice = scores + f["router"]["bias"].float()
        own, gscore = group_choice(choice, c)
        e = own if given is None else given.to(x.device).long()
        self._miss += int((e.sort(-1).values != own.sort(-1).values)
                          .any(-1).sum())
        self._choices += e.shape[0]
        gap = float(routing_gaps(choice, gscore, e, c).max())
        w = scores.gather(1, e)
        w = w / w.sum(-1, keepdim=True) * c["routed_scaling_factor"]
        first, held = experts_held(c)
        local = e - first
        mine = (local >= 0) & (local < held)
        keep = mine.clone()
        C = capacity(P, k, E, c["capacity_factor"])
        lp = torch.where(mine[:P], local[:P], held).reshape(-1)
        onehot = torch.nn.functional.one_hot(lp, held + 1)
        rank = (torch.cumsum(onehot, 0) - 1).gather(1, lp[:, None])[:, 0]
        keep[:P] &= rank.reshape(P, k) < C
        return e, w, local, keep, gap

    def moe_ffn(self, f, x, P, given=None):
        """One MoE layer over one sequence's normed input ``x`` (T, d),
        the first ``P`` positions its prompt: (the held experts' part
        plus the shared expert, the experts followed, the widest routing
        gap)."""
        e, w, local, keep, gap = self._route(f, x, given, P)
        out = self._mlp(f["shared"], x)
        ex = f["experts"]
        for j in range(experts_held(self.cfg)[1]):
            t, slot = torch.nonzero(keep & (local == j), as_tuple=True)
            we = {"wi_gate": ex["w_gate"][j], "wi_up": ex["w_up"][j],
                  "wo": ex["w_down"][j]}
            for s in range(0, len(t), 4096):
                tb, sb = t[s:s + 4096], slot[s:s + 4096]
                out.index_add_(0, tb, self._mlp(we, x[tb])
                               * w[tb, sb][:, None])
        return out, e, gap

    def forward(self, seqs, routing=None):
        """``_forward`` with TF32 off: every float32 product in IEEE
        float32, the switches restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._forward(seqs, routing)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def _forward(self, seqs, routing):
        """``seqs``: (tokens (L,) int64 tensor, prompt length P, scored
        positions) each.  ``routing``: for each sequence, an MoE layer's
        (L, k) global expert ids of every position (the program's own
        choices); None routes by the reference's own.  Returns, per
        sequence, the float32 logits at its scored positions, the widest
        routing gap (``routing_gaps``, over positions and MoE layers),
        and the routing used; ``miss_share`` then gives the share of
        choices that were not the reference's own."""
        p, c = self.p, self.cfg
        dev = p["embed"]["table"].device
        inv = yarn_inv_freq(c, c["qk_rope_head_dim"], dev)
        hs = [p["embed"]["table"][t.to(dev)].float() for t, _, _ in seqs]
        self._miss = self._choices = 0
        used = [[] for _ in seqs]
        rgap = [0.0 for _ in seqs]
        layers = [lp for st in p["stages"] for lp in st["layers"]]
        n_moe = 0
        for layer in layers:
            f = layer["ffn"]
            for i, (_, P, _) in enumerate(seqs):
                x = self._norm(hs[i], layer["mixer_norm"]["scale"])
                hs[i] = hs[i] + self._mla(layer["mixer"], x, inv)
                x = self._norm(hs[i], layer["ffn_norm"]["scale"])
                if "router" not in f:
                    hs[i] = hs[i] + self._mlp(f, x)
                    continue
                given = None if routing is None else routing[i][n_moe]
                out, e, gap = self.moe_ffn(f, x, P, given)
                hs[i] = hs[i] + out
                used[i].append(e)
                rgap[i] = max(rgap[i], gap)
            n_moe += "router" in f
        logits = []
        un = p["unembed"]["w"]
        for i, (_, _, scored) in enumerate(seqs):
            x = self._norm(hs[i][scored], p["final_norm"]["scale"])
            logits.append(torch.cat([self._mm(x, un[:, s:s + 16384])
                                     for s in range(0, un.shape[1], 16384)],
                                    -1))
        return logits, rgap, used
