"""Multi-device sharding of the blocked CAVI problem over processes.

Counterpart of viprs_tpu.parallel.mesh. The JAX package places arrays with
NamedShardings over a ('blocks', 'grid') device mesh and lets GSPMD insert
the communication. PyTorch has no GSPMD, so the port writes it: every
process (a rank of ``torch.distributed``'s default group) owns one cell of
the mesh and runs the same host loop on its shard:

- axis ``blocks``: a contiguous range of the LD blocks (NB padded to a
  multiple of the axis, ``pad_blocks``). The rank's card holds only its
  blocks' tiles and the coupling tiles that touch them
  (``ops.block_ld.shard_blocks``). A coupling tile whose two ends lie on two
  ranks needs the other rank's eta change after each block sweep: the
  ranks of a ``blocks`` group exchange those blocks (the halo,
  ``ShardedLD.couple``) before the coupling pass runs on the rank's tiles.
- axis ``grid``: the model lanes S, split into contiguous ranges when S
  divides by the axis, else every rank of a ``grid`` group holds all lanes
  (replicated).

The EM loops read one small float64 vector from the card per iteration;
under a mesh that vector is gathered over the ``blocks`` group (sums and
maxima, added in rank order) and then over the ``grid`` group (lanes), so
every rank runs the same float64 M-step and convergence ladder and takes
the same decisions. Collectives run on host tensors over gloo process
groups: the same code serves CPU processes, several ranks sharing one card
and several cards.
"""

import dataclasses
import os

import numpy as np
import torch

from ..ops.block_ld import (BlockLD, ShardView, halo_plan, shard_blocks,
                            shard_rows)
from ..ops.cavi_torch import CaviState

F32 = torch.float32


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(devices=None):
    """The device of this rank: ``devices[rank]`` when given, else the
    rank's card (``cuda:{LOCAL_RANK % device_count}``) where CUDA is
    available, else the CPU."""
    _, rank = _world()
    if devices is not None:
        return torch.device(devices[rank])
    if torch.cuda.is_available():
        local = int(os.environ.get('LOCAL_RANK', rank))
        return torch.device('cuda', local % torch.cuda.device_count())
    return torch.device('cpu')


class Mesh:
    """A ('blocks', 'grid') mesh over the ranks of the default process
    group: rank r is cell ``divmod(r, shape['grid'])`` of the
    (blocks, grid) array, as the JAX package reshapes its device list.

    :ivar shape: {'blocks': n_blocks_axis, 'grid': n_grid_axis}.
    :ivar coords: (blocks index, grid index) of this rank.
    :ivar device: this rank's device (``rank_device``).
    :ivar blocks_group, grid_group: the gloo process groups of the ranks
        that share this rank's grid index (they split the blocks) and its
        blocks index (they split the lanes); None where the group is this
        rank alone.
    """
    axis_names = ('blocks', 'grid')

    def __init__(self, n_blocks_axis, n_grid_axis, devices=None):
        world, rank = _world()
        if n_blocks_axis * n_grid_axis != world:
            raise ValueError(f"mesh {n_blocks_axis}x{n_grid_axis} != "
                             f"{world} processes")
        self.shape = {'blocks': int(n_blocks_axis), 'grid': int(n_grid_axis)}
        self.size, self.rank = world, rank
        self.coords = divmod(rank, n_grid_axis)
        self.device = rank_device(devices)
        self.blocks_group = self.grid_group = None
        if world > 1:
            import torch.distributed as dist
            # every rank creates every group, in the same order
            for g in range(n_grid_axis):
                grp = dist.new_group([b * n_grid_axis + g
                                      for b in range(n_blocks_axis)],
                                     backend='gloo')
                if g == self.coords[1] and n_blocks_axis > 1:
                    self.blocks_group = grp
            for b in range(n_blocks_axis):
                grp = dist.new_group([b * n_grid_axis + g
                                      for g in range(n_grid_axis)],
                                     backend='gloo')
                if b == self.coords[0] and n_grid_axis > 1:
                    self.grid_group = grp

    def __repr__(self):
        return (f"Mesh(blocks={self.shape['blocks']}, "
                f"grid={self.shape['grid']}, rank={self.rank})")

    # ------------------------------------------------------- the layout
    def block_bounds(self, nb):
        """The shards' block boundaries over NB blocks padded to a multiple
        of the blocks axis: (n_blocks_axis + 1,) ints."""
        n = self.shape['blocks']
        per = -(-nb // n)
        return [i * per for i in range(n + 1)]

    def splits_lanes(self, S):
        """True when S lanes split over the grid axis (it divides S); else
        every rank of a grid group holds all S."""
        g = self.shape['grid']
        return g > 1 and S % g == 0

    def lane_range(self, S):
        """This rank's lanes [l0, l1) of S (all of them when replicated)."""
        if not self.splits_lanes(S):
            return 0, S
        w = S // self.shape['grid']
        return self.coords[1] * w, (self.coords[1] + 1) * w

    def lane_home(self, S):
        """(S,) grid index of the rank holding each lane (S split)."""
        return np.arange(S) // (S // self.shape['grid'])

    # ------------------------------------------------------ collectives
    def gather(self, t, axis):
        """All-gather the host tensor ``t`` over the ranks of the group
        that splits ``axis`` ('blocks' or 'grid'): a list in the group's
        rank order (the same on every rank)."""
        group = self.blocks_group if axis == 'blocks' else self.grid_group
        t = t.contiguous()
        if group is None:
            return [t]
        import torch.distributed as dist
        out = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(out, t, group=group)
        return out

    def lane_layout(self, lanes):
        """Which lanes each rank of the grid group holds (a collective):
        (list of index arrays in the group's rank order, the widest count,
        this rank's count). ``lanes``: this rank's lane indices."""
        lanes = np.asarray(lanes, np.int64)
        counts = [int(c) for c in self.gather(torch.tensor([len(lanes)]),
                                              'grid')]
        width = max(counts)
        pad = np.full(width, -1, np.int64)
        pad[:len(lanes)] = lanes
        who = [w.numpy()[:c] for w, c in
               zip(self.gather(torch.from_numpy(pad), 'grid'), counts)]
        return who, width, len(lanes)

    def gather_lanes(self, rows, layout, S):
        """Assemble (R, S) from each grid rank's (R, its lane count) rows,
        placed by ``layout`` (``lane_layout``)."""
        who, width, n = layout
        buf = np.zeros((rows.shape[0], width), rows.dtype)
        buf[:, :n] = rows
        got = self.gather(torch.from_numpy(buf), 'grid')
        out = np.zeros((rows.shape[0], S), rows.dtype)
        for idx, part in zip(who, got):
            out[:, idx] = part.numpy()[:, :len(idx)]
        return out


#: The meshes made so far, by (axes, the default group): a spec resolves to
#: the same Mesh each time, so models over one dataset share its shard of
#: the LD (``SummaryStatsDataset.ld_for_mesh`` caches by mesh), as equal
#: JAX meshes do.
_MESHES = {}


def make_mesh(n_blocks_axis=None, n_grid_axis=1, devices=None):
    """A ('blocks', 'grid') mesh over the ranks of the default process group
    (a single process without one is a 1 x 1 mesh); the product of the two
    axes must be the number of processes. The same axes give the same Mesh
    (its process groups are made once).

    :param devices: one device per rank (default: each rank's card, or the
        CPU without CUDA; see ``rank_device``).
    """
    import torch.distributed as dist
    world, _ = _world()
    if n_blocks_axis is None:
        n_blocks_axis = world // n_grid_axis
    group = dist.group.WORLD if dist.is_available() and \
        dist.is_initialized() else None
    key = (int(n_blocks_axis), int(n_grid_axis),
           None if devices is None else tuple(str(d) for d in devices),
           id(group))
    if key not in _MESHES:
        _MESHES[key] = Mesh(n_blocks_axis, n_grid_axis, devices)
    return _MESHES[key]


def resolve_mesh(mesh='auto'):
    """Resolve a user-facing mesh spec into a Mesh or None.

    :param mesh: one of
        - ``'auto'``: every rank on the ``blocks`` axis when there is more
          than one process; ``None`` (one device) otherwise;
        - ``None`` / ``'off'`` / ``False``: one device;
        - a ``Mesh``: used as is;
        - a string ``'<NB>x<NG>'`` (e.g. ``'4x2'``): explicit axis sizes,
          whose product must be the number of processes.
    """
    if mesh is None or mesh is False or mesh == 'off':
        return None
    if isinstance(mesh, Mesh):
        return mesh
    if mesh == 'auto':
        n, _ = _world()
        return make_mesh(n, 1) if n > 1 else None
    if isinstance(mesh, str) and 'x' in mesh:
        try:
            nb_ax, g_ax = (int(v) for v in mesh.split('x', 1))
        except ValueError:
            nb_ax = None
        if nb_ax is not None:
            return make_mesh(nb_ax, g_ax)
    raise ValueError(f"Cannot resolve mesh spec {mesh!r}; expected 'auto', "
                     f"'off', '<NB>x<NG>', or a Mesh.")


# ------------------------------------------------------------ the shard
@dataclasses.dataclass(eq=False)
class ShardedLD:
    """This rank's shard of a BlockLD under a mesh: the operator the EM
    loops and the models take in place of a BlockLD.

    :ivar mesh: the Mesh.
    :ivar view: the ShardView (the rank's blocks and the coupling tiles
        that touch them, on the rank's device).
    :ivar nb_total: NB of the unpadded LD (the hybrid gate's count).
    :ivar nb_padded: NB padded to a multiple of the blocks axis.
    :ivar ghost_from: (n_ghost, 2) (shard, row of its exports) each ghost
        slot is filled from.
    :ivar halo_rows: the most exports of any shard of the blocks group
        (0: no coupling tile crosses a shard boundary, nothing is
        exchanged).
    """
    mesh: Mesh
    view: ShardView
    nb_total: int
    nb_padded: int
    ghost_from: np.ndarray
    halo_rows: int

    @property
    def ld(self) -> BlockLD:
        return self.view.ld

    @property
    def mask(self):
        return self.view.ld.mask

    @property
    def device(self):
        return self.view.ld.device

    @property
    def nb(self):
        return self.view.ld.nb

    @property
    def block_size(self):
        return self.view.ld.block_size

    @property
    def scale(self):
        return self.view.ld.scale

    @property
    def lo(self):
        return self.view.lo

    @property
    def hi(self):
        return self.view.hi

    def nbytes(self):
        """Bytes of LD tiles on the rank's device (diagonal and coupling)."""
        n = self.view.ld.diag.numel() * self.view.ld.diag.element_size()
        if self.view.cpl is not None:
            off = self.view.cpl.off_data
            n += off.numel() * off.element_size()
        return n

    # -------------------------------------------------------- the halo
    def exchange(self, x, flags=None):
        """The ghost blocks of ``x`` ((S, NB_local, B) float32 on the
        rank's device): each rank of the blocks group sends its exported
        blocks (and their ``flags``, (NB_local,) int) through the host.
        Returns (ghost x (S, n_ghost, B), ghost flags (n_ghost,) int32) on
        the device, or None when nothing crosses a shard boundary. A
        collective: every rank of the group calls it in lockstep."""
        if self.halo_rows == 0:
            return None
        S, _, B = x.shape
        exp = self.view.exports
        send = torch.zeros((self.halo_rows, S * B + 1), dtype=F32)
        if len(exp):
            idx = torch.from_numpy(exp).to(x.device)
            rows = x.index_select(1, idx).permute(1, 0, 2).reshape(
                len(exp), S * B)
            send[:len(exp), :S * B] = rows.cpu()
            if flags is not None:
                send[:len(exp), S * B] = flags.index_select(0, idx).to(
                    F32).cpu()
        got = self.mesh.gather(send, 'blocks')
        n_g = len(self.ghost_from)
        if n_g == 0:
            return None
        vals = torch.stack([got[s][r] for s, r in self.ghost_from])
        gx = vals[:, :S * B].reshape(n_g, S, B).permute(1, 0, 2) \
            .contiguous().to(x.device)
        gf = vals[:, S * B].to(torch.int32).to(x.device)
        return gx, gf

    def couple(self, couple_fn, q, eta_diff, blk_mask):
        """The coupling pass after a block sweep of the shard: the ghost
        blocks' eta change and flags come from the ranks that own them,
        then ``couple_fn`` (the pass the unsharded sweep runs:
        ``cavi_cuda._couple_s1`` or ``_couple_s``) applies the rank's
        coupling tiles, each destination block's tiles in their global
        order, so the rank's blocks of q are the unsharded pass's. Returns
        q (S, NB_local, B)."""
        halo = self.exchange(eta_diff, blk_mask)
        cpl = self.view.cpl
        if cpl is None:
            return q
        if halo is None:
            return couple_fn(cpl, q, eta_diff, blk_mask)
        gx, gf = halo
        S, nb, B = q.shape
        q_ext = torch.cat([q, torch.zeros((S, gx.shape[1], B), dtype=F32,
                                          device=q.device)], dim=1)
        q_ext = couple_fn(cpl, q_ext, torch.cat([eta_diff, gx], dim=1),
                          torch.cat([blk_mask.to(torch.int32), gf]))
        return q_ext[:, :nb].contiguous()

    def compute_q(self, eta):
        """q = (R - I) eta of the rank's blocks (``cavi_torch.compute_q``),
        the coupling tiles' terms from the ghost blocks' eta (a
        collective)."""
        from ..ops import cavi_torch
        q = cavi_torch.compute_q(self.view.ld, eta)
        halo = self.exchange(eta.to(F32))
        cpl = self.view.cpl
        if cpl is None:
            return q
        e = eta.to(F32)
        if halo is not None:
            e = torch.cat([e, halo[0]], dim=1)
        off = cavi_torch._off_contrib(cpl, e, out_dtype=eta.dtype)
        return q + off[:, :self.nb]

    # --------------------------------------------------- the reductions
    def reduce(self, sums, maxes=None, layout=None, S=None):
        """Per-lane sums (R, S_local) and maxima (R2, S_local) over the
        rank's blocks -> over every block, added (or maxed) in rank order
        so every rank gets the same bits; then, when the lanes are split
        (``layout``, ``Mesh.lane_layout`` of this rank's lanes of S),
        gathered over the grid group into (R, S) and (R2, S). float64
        numpy in and out."""
        sums = np.asarray(sums, np.float64)
        maxes = np.zeros((0, sums.shape[1])) if maxes is None else \
            np.asarray(maxes, np.float64)
        r = sums.shape[0]
        x = torch.from_numpy(np.concatenate([sums, maxes]))
        parts = [p.numpy() for p in self.mesh.gather(x, 'blocks')]
        tot = parts[0].copy()
        for p in parts[1:]:
            tot[:r] = tot[:r] + p[:r]
            tot[r:] = np.maximum(tot[r:], p[r:])
        if layout is not None:
            tot = self.mesh.gather_lanes(tot, layout, S)
        return tot[:r], tot[r:]

    def count_blocks(self, blk, lanes_split=False):
        """A block mask of the rank's blocks ((NB_local,) bool on the
        device) made global: OR'd over the grid group when the lanes are
        split (the union over every live lane of the fit), then the number
        of flagged blocks over every rank. Returns (mask as (NB_local,)
        int32 on the device, count)."""
        host = blk.to(torch.int32).cpu()
        if lanes_split:
            host = torch.stack(self.mesh.gather(host, 'grid')).amax(dim=0)
        n = sum(int(p) for p in self.mesh.gather(host.sum().reshape(1),
                                                  'blocks'))
        return host.to(blk.device), n


def pad_blocks(ld: BlockLD, multiple: int) -> BlockLD:
    """Pad the NB axis with empty blocks to a multiple (for even
    sharding): zero tiles, zero mask and zero flags, the coupling tiles
    unchanged (padding appends blocks at the end)."""
    nb = ld.nb
    target = -(-nb // multiple) * multiple
    if target == nb:
        return ld
    pad = target - nb

    def more(x):
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=x.device)])
    from ..ops.block_ld import incident_tiles
    inc_ptr, _ = incident_tiles(ld.off_src.cpu().numpy(),
                                ld.off_dst.cpu().numpy(), target)
    return dataclasses.replace(
        ld, diag=more(ld.diag), mask=more(ld.mask), diag_nz=more(ld.diag_nz),
        inc_ptr=torch.from_numpy(inc_ptr).to(ld.device))


def shard_ld(mesh: Mesh, ld: BlockLD, device=None) -> ShardedLD:
    """This rank's shard of ``ld`` on ``device`` (default the mesh's): its
    range of the blocks (NB padded to a multiple of the blocks axis) and
    the coupling tiles that touch it, with the halo plan. Only the shard's
    tiles are copied to ``device``; ``ld`` may stay on the host."""
    device = mesh.device if device is None else torch.device(device)
    bounds = mesh.block_bounds(ld.nb)
    src, dst = ld.off_src.cpu().numpy(), ld.off_dst.cpu().numpy()
    plans = halo_plan(src, dst, bounds)
    me = mesh.coords[0]
    view = shard_blocks(ld, bounds[me], bounds[me + 1], device,
                        plan=plans[me])
    ghost_from = np.array(
        [(s, int(np.searchsorted(plans[s][1], g - bounds[s])))
         for g in view.ghosts
         for s in [int(np.searchsorted(bounds, g, side='right')) - 1]],
        np.int64).reshape(-1, 2)
    return ShardedLD(mesh=mesh, view=view, nb_total=ld.nb,
                     nb_padded=bounds[-1], ghost_from=ghost_from,
                     halo_rows=max(len(p[1]) for p in plans))


def shard_flat(mesh: Mesh, x, target_nb: int, device=None):
    """This rank's rows of an (NB, B) per-variant input padded to
    ``target_nb`` blocks, on ``device`` (default the mesh's)."""
    device = mesh.device if device is None else device
    bounds = mesh.block_bounds(target_nb)
    b = mesh.coords[0]
    return shard_rows(torch.as_tensor(x), bounds[b], bounds[b + 1], device)


def shard_state(mesh: Mesh, state: CaviState, target_nb: int,
                device=None) -> CaviState:
    """This rank's part of an (S, NB, B) CaviState: its blocks of NB padded
    to ``target_nb``, and its lanes when S divides by the grid axis."""
    S = state.logits.shape[0]
    l0, l1 = mesh.lane_range(S)
    return CaviState(*(shard_flat(mesh, x[l0:l1].transpose(0, 1),
                                  target_nb, device).transpose(0, 1)
                       .contiguous() for x in state))


def shard_problem(mesh: Mesh, ld: BlockLD, state: CaviState, std_beta,
                  n_per_snp, device=None):
    """This rank's part of a problem: (ShardedLD, its CaviState, its
    std_beta and n_per_snp rows), on ``device`` (default the mesh's).
    Padded blocks carry mask 0 and contribute nothing."""
    sld = shard_ld(mesh, ld, device)
    dev = sld.device
    return (sld, shard_state(mesh, state, sld.nb_padded, dev),
            shard_flat(mesh, std_beta, sld.nb_padded, dev),
            shard_flat(mesh, n_per_snp, sld.nb_padded, dev))
