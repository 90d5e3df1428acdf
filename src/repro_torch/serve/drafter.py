"""Draft-token proposers for the speculative decode lanes.

PyTorch-side copy of ``repro.serve.drafter`` (which imports JAX).  The
verify step makes *any* drafter lossless: a wrong draft only costs
acceptance rate, never output correctness, so drafters are free to be
cheap and approximate.

* :class:`NGramDrafter` (``kind="host"``): prompt-lookup decoding.  The
  last n-gram of the committed context (prompt + emitted tokens) is looked
  up at its most recent earlier occurrence and the tokens that followed it
  are proposed.  Zero model cost, pure host Python.
* :class:`MTPDrafter` (``kind="model"``): DeepSeek-V3's
  multi-token-prediction head drafts every slot at once on the engine's
  device, from the hidden state at each slot's last committed position.

Tree drafts (the ``spec_tree`` lane) are ``(tokens, parents)`` pairs in
*draft space*: ``parents[i]`` is the index of node i's parent among the
drafted nodes, or -1 for a child of the root (the last committed token; the
engine holds window index 0 for it).  Parents are topological
(``parents[i] < i``) and siblings carry distinct tokens, so the engine's
accept walk is unambiguous.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def chain_parents(n: int) -> list[int]:
    """Draft-space parents of a linear chain: [-1, 0, 1, ...]."""
    return list(range(-1, n - 1))


def tree_depths_ancestors(parents: list[int]) -> tuple[list[int], list[int]]:
    """Window-space (depth, ancestor-bitmask) lists for a draft tree.

    ``parents`` is draft-space (see module docstring); the returned lists
    have length ``len(parents) + 1`` and describe the *window*: entry 0 is
    the root (depth 0, anc bit 0), entry i+1 is draft node i at window
    index i+1 with bit i+1 OR'd onto its parent's mask -- the operands
    :func:`repro_torch.models.transformer.verify_step` takes in tree mode.
    """
    depth = [0]
    anc = [1]
    for i, p in enumerate(parents):
        if not -1 <= p < i:
            raise ValueError(f"parents[{i}] = {p} is not topological")
        w = i + 1
        depth.append(depth[p + 1] + 1)
        anc.append(anc[p + 1] | (1 << w))
    return depth, anc


class Drafter:
    """Base: subclasses set ``kind`` and implement :meth:`draft`."""

    name = "base"
    kind = "host"

    def draft(self, context: list[int], k: int) -> list[int]:
        raise NotImplementedError

    def draft_tree(self, context: list[int], n: int,
                   branch: int) -> tuple[list[int], list[int]]:
        """(tokens, draft-space parents) with up to ``n`` nodes.  Default:
        the linear draft as a single chain, so any drafter works in the tree
        lane unchanged; branching only raises acceptance."""
        return self.draft(context, n), chain_parents(n)


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the context's trailing n-gram (longest n first),
    falling back to repeat-last when nothing matches."""

    name = "ngram"
    kind = "host"

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError("ngram drafter needs max_n >= 1")
        self.max_n = max_n

    def draft(self, context: list[int], k: int) -> list[int]:
        L = len(context)
        for n in range(min(self.max_n, L - 1), 0, -1):
            pat = context[-n:]
            for i in range(L - n - 1, -1, -1):
                if context[i:i + n] == pat:
                    cont = context[i + n:i + n + k]
                    if cont:
                        return (cont + [cont[-1]] * k)[:k]
        return [context[-1]] * k

    def _candidates(self, context: list[int], k: int,
                    branch: int) -> list[list[int]]:
        """Up to ``branch`` candidate continuations with distinct first
        tokens, in the same longest-n / most-recent-match preference order
        :meth:`draft` uses (so candidate 0 is the linear draft's choice)."""
        L = len(context)
        out: list[list[int]] = []
        seen: set[int] = set()
        for n in range(min(self.max_n, L - 1), 0, -1):
            pat = context[-n:]
            for i in range(L - n - 1, -1, -1):
                if context[i:i + n] == pat:
                    cont = context[i + n:i + n + k]
                    if cont and cont[0] not in seen:
                        seen.add(cont[0])
                        out.append(cont)
                        if len(out) >= branch:
                            return out
        return out

    def draft_tree(self, context: list[int], n: int,
                   branch: int) -> tuple[list[int], list[int]]:
        """Branch on the top candidate continuations: the best match keeps a
        chain of the remaining budget (identical to the linear draft), and
        each runner-up (distinct first token) hangs one node off the root,
        covering the most likely divergence point, the first drafted
        token."""
        cands = self._candidates(context, n, max(1, branch))
        if not cands:
            return [context[-1]] * n, chain_parents(n)
        extras = cands[1:n]                     # keep >= 1 node for the chain
        main_len = n - len(extras)
        main = (cands[0] + [cands[0][-1]] * n)[:main_len]
        toks = list(main)
        parents = chain_parents(main_len)
        for c in extras:
            toks.append(c[0])
            parents.append(-1)
        return toks, parents


class MTPDrafter(Drafter):
    """Batched MTP-head drafting over the slot pool: ``hidden`` [B, d] is the
    post-``ln_f`` hidden at each slot's last committed position (zeros
    right after a prefill: the head runs from the embedding there),
    ``token`` [B] the last committed tokens and ``pos`` [B] the cursors,
    all on the engine's device; the drafts run eagerly there.  With
    ``tree_branch`` set, :meth:`draft_tree_batch` beams the head instead:
    the top-``branch`` first tokens each root a greedy chain, the static
    chain-major topology in :attr:`tree_parents`."""

    name = "mtp"
    kind = "model"

    def __init__(self, cfg: ModelConfig, rt, k: int, tree_branch: int | None = None):
        if not cfg.mtp:
            raise ValueError(f"{cfg.name} has no MTP head (cfg.mtp is False); "
                             "use the ngram drafter")
        self.cfg, self.rt, self.k = cfg, rt, k
        self.tree_branch = tree_branch
        self.tree_parents: list[int] | None = None
        if tree_branch is not None:
            parents: list[int] = []
            for clen in T.mtp_chain_lengths(k, tree_branch):
                prev = -1
                for _ in range(clen):
                    parents.append(prev)
                    prev = len(parents) - 1
            self.tree_parents = parents

    def draft_batch(self, params, hidden, token, pos):
        """int32 [B, k] drafts on the device."""
        return M.mtp_draft(params, self.cfg, hidden, token, pos, self.k, self.rt)

    def draft_tree_batch(self, params, hidden, token, pos):
        """int32 [B, k] tree nodes (chain-major) on the device."""
        return M.mtp_draft_tree(params, self.cfg, hidden, token, pos, self.k,
                                self.tree_branch, self.rt)


def make_drafter(spec: "str | Drafter | None", cfg: ModelConfig, rt=None, k: int = 0,
                 tree_branch: int | None = None) -> Drafter:
    """``"ngram" | "ngram:N"`` (max n-gram) | ``"mtp"`` or a built
    instance.  ``k`` is the draft budget and ``tree_branch`` (the engine's
    ``spec_branch``, tree lane only) builds the model drafter's beam
    topology; ``"mtp"`` raises ``ValueError`` on a configuration without
    the head."""
    if spec is None:
        return NGramDrafter()
    if isinstance(spec, Drafter):
        return spec
    name, _, arg = spec.partition(":")
    if name == "ngram":
        return NGramDrafter(max_n=int(arg)) if arg else NGramDrafter()
    if name == "mtp":
        return MTPDrafter(cfg, rt, k, tree_branch=tree_branch)
    raise ValueError(f"unknown drafter {spec!r}; one of ['ngram', 'mtp']")
