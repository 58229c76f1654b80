"""Region-decomposed global simulator — the port of
``repro/core/gs_sharded.py``.

The factored-randomness protocol (``repro_torch.envs.base``) makes every
region's next state depend only on its local state, its realized
influence sources and its exo slice (Definition 3). That licenses
running the GS as region blocks that exchange only boundary influence:
each rank of the shard mesh (``repro_torch.distributed.runtime``)
simulates its own block of N/S agents.

One GS step, block-decomposed (:func:`make_block_step`):

1. **halo exchange** — each block sends its (local states, actions)
   slice one hop around the block ring in both directions
   (``repro_torch.distributed.collectives.halo_exchange``: the ONLY
   communication a sharded-GS body may contain);
2. **boundary influence** — the env's ``boundary_influence`` evaluates
   on a zero-padded full-size view holding blocks {b-1, b, b+1}; by the
   locality contract of ``region_partition`` the block's own rows of the
   result are exactly the replicated ``u`` (zero rows are inert);
3. **region transitions** — ``ls_step_given`` (the per-region transition
   shared verbatim with the LS) advances the block's agents with the
   realized ``u`` and their ``exo_locals`` slice.

Exogenous draws, action noise and reset draws are *replicated*: every
block evaluates the same counter-based draws from the same key and
keeps its rows, so the block trajectory reproduces the replicated
``gs_step`` trajectory bit for bit under a shared key stream. The
boundary term itself runs on the zero-padded full-size view (O(N) rows
per block), which buys equivalence by construction, as in the reference.

:func:`make_sharded_collector` and :func:`make_sharded_evaluator` are
the per-rank twins of ``repro_torch.core.gs.make_collector`` and
``repro_torch.marl.runner.make_gs_eval``: the collector emits this
rank's (B, E, T, ...) slice of the (N, E, T, ...) dataset (no
post-collect re-placement), the evaluator's ``body`` returns the block's
mean return and ``eval_fn`` means the blocks' with one all-reduce,
outside the body.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import env_pool
from repro_torch.distributed import collectives
from repro_torch.marl import policy as policy_mod
from repro_torch.obs.trace import annotate
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# partition validation
# ---------------------------------------------------------------------------
def partition(env_mod, env_cfg, n_blocks: int) -> np.ndarray:
    """The env's validated agent→block assignment. The halo ring below
    assumes the canonical contiguous equal-size layout (block b owns
    agents [b·B, (b+1)·B)), so anything else is rejected."""
    from repro_torch.envs import base
    n_agents = env_cfg.info().n_agents
    part = np.asarray(env_mod.region_partition(env_cfg, n_blocks))
    canonical = base.contiguous_partition(n_agents, n_blocks)
    if part.shape != (n_agents,) or not np.array_equal(part, canonical):
        raise ValueError(
            f"{env_cfg.info().name}.region_partition({n_blocks}) is not "
            f"the contiguous equal-size layout the sharded GS requires")
    return part


def partition_supported(env_mod, env_cfg, n_blocks: int):
    """(ok, reason): can this env's GS decompose into ``n_blocks``?
    False for topologies that cannot tile (grid side not divisible) and
    for env modules without the spatial-decomposition hooks."""
    if not hasattr(env_mod, "boundary_influence"):
        return False, f"{env_cfg.info().name} has no boundary_influence"
    try:
        partition(env_mod, env_cfg, n_blocks)
        return True, ""
    except (AttributeError, ValueError) as e:
        return False, str(e)


# ---------------------------------------------------------------------------
# the block-decomposed GS step
# ---------------------------------------------------------------------------
def _place_window(own, prev, nxt, blk: int, n_blocks: int, n_agents: int):
    """Zero-padded full-size view (agent axis 1, after the streams) with
    blocks {b-1, b, b+1} at their absolute agent rows (mod-ring).
    Overlapping writes (1- or 2-block rings) carry identical data, so
    their order is irrelevant."""
    bsz = n_agents // n_blocks

    def one(o, p, x):
        full = o.new_zeros(o.shape[:1] + (n_agents,) + o.shape[2:])
        for delta, leaf in ((-1, p), (0, o), (1, x)):
            c = (blk + delta) % n_blocks
            full[:, c * bsz:(c + 1) * bsz] = leaf
        return full

    return tree_map(one, own, prev, nxt)


def make_block_step(env_mod, env_cfg, *, mesh):
    """One GS step for this rank's block of E env streams.

    ``block_step(loc, t, actions, exo) ->
        (loc', obs (E, B, O), rew (E, B), u (E, B, M), done (E,), t')``

    ``loc``: this block's ``gs_locals``-schema slice (leaves (E, B, ...));
    ``t``: (E,) step counters (identical on every block);
    ``actions``: (E, B) the block's joint-action slice;
    ``exo``: the FULL exogenous draw (replicated: every block holds it).
    """
    n_agents = env_cfg.info().n_agents
    n_blocks = mesh.n_shards
    partition(env_mod, env_cfg, n_blocks)
    rows = mesh.block(n_agents)

    def block_step(loc, t, actions, exo):
        with annotate("halo_exchange"):
            prev, nxt = collectives.halo_exchange((loc, actions), mesh)
        view_loc, view_act = _place_window(
            (loc, actions), prev, nxt, mesh.rank, n_blocks, n_agents)
        with annotate("boundary_influence"):
            u_full = env_mod.boundary_influence(view_loc, view_act, exo,
                                                env_cfg)   # (E, N, M)
        u = u_full[:, rows]
        exo_blk = tree_map(lambda x: x[:, rows],
                           env_mod.exo_locals(exo, env_cfg))
        t_blk = t[:, None].expand(actions.shape)
        new, obs, rew, _done = env_mod.ls_step_given(
            {**loc, "t": t_blk}, actions, u, exo_blk, env_cfg)
        loc2 = {k: v for k, v in new.items() if k != "t"}
        t2 = t + 1
        return loc2, obs, rew, u, t2 >= env_cfg.horizon, t2

    return block_step


def _block_plumbing(env_mod, env_cfg, mesh):
    info = env_cfg.info()
    if info.n_agents % mesh.n_shards:
        raise ValueError(f"{info.n_agents} agents cannot tile "
                         f"{mesh.n_shards} GS blocks")
    rows = mesh.block(info.n_agents)
    block_step = make_block_step(env_mod, env_cfg, mesh=mesh)

    def init_block_locals(keys):
        """Replicated ``gs_init`` (the same keys on every block — cheap,
        counter-based), restricted to this block's agents."""
        states = env_mod.gs_init(keys, env_cfg)
        loc = tree_map(lambda x: x[:, rows],
                       env_mod.gs_locals(states, env_cfg))  # (E, B, ...)
        return loc, states["t"]                              # t: (E,)

    return info, rows, block_step, init_block_locals


def _init_streams(init_block_locals, skeys):
    """Fresh block states of the streams from their init keys (chain
    step 0), as ``env_pool.GSPool.init``."""
    return init_block_locals(env_pool.init_keys(skeys))


# ---------------------------------------------------------------------------
# Algorithm 2 on the mesh
# ---------------------------------------------------------------------------
def make_sharded_collector(env_mod, env_cfg,
                           policy_cfg: policy_mod.PolicyConfig, *,
                           n_envs: int, steps: int, mesh):
    """Per-rank twin of :func:`repro_torch.core.gs.make_collector`:
    ``collect(policy_params (B, ...) this block's, key) -> dataset`` with
    leaves (B, n_envs, steps, ...): feats, u, resets, this rank's rows of
    the replicated collector's (N, n_envs, steps, ...) dataset. The key
    plumbing is the replicated collector's (the same per-stream fold-in
    chains, evaluated on every block), so the dataset is the replicated
    one bit for bit, given bit-equal policy forwards."""
    info, rows, block_step, init_block_locals = _block_plumbing(
        env_mod, env_cfg, mesh)
    dev, n_agents, bsz = mesh.device, info.n_agents, rows.stop - rows.start

    def categorical_block(keys, logits):
        """The replicated collector draws one categorical PER STREAM over
        that stream's full (N, A) logits; the Gumbel bits depend only on
        the stream key and the (row, column) position, so the same draw
        on a zero-padded full-agent view, read at this block's rows,
        reproduces the sampled actions bit for bit."""
        full = logits.new_zeros(logits.shape[:1] + (n_agents,)
                                + logits.shape[2:])
        full[:, rows] = logits
        return policy_mod.sample_action(keys, full)[0][:, rows]

    @torch.no_grad()
    def collect(params, key):
        skeys = env_pool.stream_keys(key.to(dev), n_envs)
        loc, t = _init_streams(init_block_locals, skeys)
        obs = env_mod.ls_obs(loc, env_cfg)                    # (E, B, O)
        h = policy_mod.initial_hidden(policy_cfg, n_envs, bsz, device=dev)
        prev_a = torch.zeros((n_envs, bsz), dtype=torch.int64, device=dev)
        prev_done = torch.ones((n_envs,), dtype=torch.bool, device=dev)
        shape = (bsz, n_envs, steps)
        bufs = {"feats": torch.zeros(shape + (info.alsh_dim,), device=dev),
                "u": torch.zeros(shape + (info.n_influence,), device=dev),
                "resets": torch.zeros(shape, device=dev)}
        for ti in range(steps):
            k_act, k_env, k_reset = env_pool.step_keys(skeys, ti, 3)
            feat = torch.cat([obs, torch.nn.functional.one_hot(
                prev_a, info.n_actions).float()], dim=-1)
            logits, _, h2 = policy_mod.policy_apply_streams(
                params, obs, h, policy_cfg)
            action = categorical_block(k_act, logits)
            exo = env_mod.gs_exo(k_env, env_cfg)
            loc2, obs2, _rew, u, done, t2 = block_step(loc, t, action, exo)
            fresh_loc, fresh_t = init_block_locals(k_reset)
            loc = env_pool.reset_where(done, fresh_loc, loc2)
            t = torch.where(done, fresh_t, t2)
            obs = env_pool.reset_where(done, env_mod.ls_obs(loc, env_cfg),
                                       obs2)
            h, prev_a = env_pool.zero_on_done(done, (h2, action))
            bufs["feats"][:, :, ti].copy_(feat.transpose(0, 1))
            bufs["u"][:, :, ti].copy_(u.transpose(0, 1))
            bufs["resets"][:, :, ti].copy_(prev_done[None, :].float())
            prev_done = done
        return bufs

    return collect


# ---------------------------------------------------------------------------
# GS eval on the mesh
# ---------------------------------------------------------------------------
def make_sharded_evaluator(env_mod, env_cfg,
                           policy_cfg: policy_mod.PolicyConfig, *, mesh):
    """Per-rank twin of :func:`repro_torch.marl.runner.make_gs_eval`:
    deterministic (argmax) rollout of full episodes, block-decomposed.
    ``eval_fn(params (B, ...), key, *, episodes)`` returns the global
    mean return (a 0-d tensor, the same on every rank): ``eval_fn.body``
    (the GS body: halo exchanges only) gives the block's mean, and the
    blocks' means are averaged with one all-reduce (equal block sizes
    make the mean of block means the global mean)."""
    info, rows, block_step, init_block_locals = _block_plumbing(
        env_mod, env_cfg, mesh)
    dev, bsz = mesh.device, rows.stop - rows.start

    @torch.no_grad()
    def body(params, key, episodes: int = 4):
        ks = R.split(key.to(dev), 2)
        loc, t = init_block_locals(R.split(ks[0], episodes))
        obs = env_mod.ls_obs(loc, env_cfg)
        h = policy_mod.initial_hidden(policy_cfg, episodes, bsz, device=dev)
        rews = []
        for k in R.split(ks[1], info.horizon):
            logits, _, h = policy_mod.policy_apply_streams(params, obs, h,
                                                           policy_cfg)
            action = torch.argmax(logits, dim=-1)
            exo = env_mod.gs_exo(R.split(k, episodes), env_cfg)
            loc, obs, rew, _u, _done, t = block_step(loc, t, action, exo)
            rews.append(rew)
        return torch.stack(rews).mean()

    def eval_fn(params, key, *, episodes: int = 4):
        return collectives.tree_pmean(body(params, key, episodes), mesh)

    eval_fn.body = body
    return eval_fn


# ---------------------------------------------------------------------------
# contract audit
# ---------------------------------------------------------------------------
def audit_halo_contract(program, *args, what: str = "sharded GS program"):
    """Run a sharded-GS callable once under the op recorder and hold it
    to the halo-only rule: nothing but boundary sends and receives, and
    at least one of them. Violations raise with the emitting source line
    (``repro_torch.analysis``). Every rank must call it, in the same
    order: the program communicates."""
    from repro_torch.analysis import contracts
    contracts.raise_findings(contracts.run_rules(
        [contracts.Program(name=what, roles=("gs_body",), fn=program,
                           args=args)],
        rules=(contracts.HaloOnly(),)))
