"""Spatial partitioning with halo exchange, ported from
`enhanced_unet_tpu/parallel/spatial.py`.

A micrograph too large for one card is split along H over the ranks of a
`Mesh` (`make_mesh(n, axis_name="space")`, one process per device): rank
r holds the contiguous band of rows [r * H / n, (r + 1) * H / n) of every
map, and neighbours exchange only the rows each stencil needs.  NCCL
carries device tensors between cards; under gloo (the CPU, or two ranks
sharing one card) the exchanged rows go through host memory, since gloo's
send, receive and gather take CPU tensors only, while the compute stays on
the device.

- `halo_exchange`, `shard_image_h`, `gather_image_h`: the band's halo from
  its neighbours; a rank's rows of a whole image; the whole image again.
- `make_spatial_conv3x3`: one conv3x3 on a band haloed by one row, on K2.
- `make_spatial_basic_unet`: a whole BasicUNet forward written out by
  hand, each ConvBNAct on K2 over a haloed band, the bilinear upsamples
  exchanging one edge-clamped row.
- `make_spatial_apply`: any model of `get_model`, the flagship included.
  The JAX package gets this from XLA's partitioner; here `SpatialMode`, a
  `TorchFunctionMode`, rewrites each PyTorch call of the forward that reads
  along H with one rule per kind of operation (below), and K2 and K1,
  which it cannot see, ask it for their haloed band (`ops.bands`).

Under `SpatialMode` every 4-D tensor in NCHW is a band of a map `size`
times as tall as it unless it is marked held whole on every rank (what a
reduction over H gives, a per-image vector among them; see below) or
marked NHWC (the model's input, and what a permute that moves H from dim 2
to dim 1 gives).  A height read from a map's shape (`shape`, `size()`)
carries whose it is, a band's (this rank's rows) or a whole map's, through
products and exact quotients by integers.  The rules:

- convolutions with an H extent (`F.conv2d` with a kernel, stride or
  padding above 1 in H, dilated or not) and `F.conv_transpose2d` compute
  the global rows this rank's output rows read, fetch the missing ones
  from the neighbours (zeros beyond the image) and convolve without H
  padding; max pools the same with -inf (2x2 is local);
- `F.pad` on H pads at the image's global top and bottom only: it marks the
  band, and the stencil that consumes it pads; an amount that equals the
  SAME padding of the band's height (`tf_same_pad`) is recomputed from the
  whole map's height;
- bilinear (align-corners or not) and nearest resizes take each output
  row's source rows and weights from the global sizes with PyTorch's own
  coordinate formula, the W direction by `F.interpolate`, the lerps in fp32
  with one cast; an output height must be a scale factor or a height read
  from a map's shape (a band's is this rank's rows, a whole map's is
  global), else the resize raises;
- global means and sums over H (SE, scSE, ASPP pooling): partial sums
  all-reduced, divided by the global count; adaptive average pools
  (PSPNet's bins): each bin's partial sums all-reduced, divided by its
  global size; the bins are then held whole on every rank;
- point-wise and channel operations (BN in eval mode, activations, `cat`
  on channels, 1x1 convolutions, `expand`, casts and layouts) are local;
  a permute may move H only between dims 2 and 1 (NCHW and NHWC), and a
  reshape may split W or group a band's rows, never merge H into another
  dim;
- a stencil that reaches past a neighbour's band runs on the whole map,
  all-gathered, and keeps its own rows (ASPP's rates at stride 16, the
  deep maps of small inputs); where a band of one row meets a stride-2
  step, the smaller map is held whole on every rank, and a whole map that
  meets a band gives the band's rows;
- a transposed convolution whose global output has rows beyond the bands
  (LinkNet's 2H + 1) marks them, and only a slice that drops them along H
  is taken;
- every other operation that reads or moves along H raises
  `NotImplementedError` naming it: nothing computes on a band as if it
  were the whole map.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from enhanced_unet_tpu_torch.models.blocks import packed_conv3x3
from enhanced_unet_tpu_torch.ops import bands
from enhanced_unet_tpu_torch.ops.kernels.conv_fused import (
    fused_conv3x3_bn_relu,
    fused_conv3x3_bn_relu_packed,
)
from enhanced_unet_tpu_torch.parallel.mesh import Mesh

# ---- transport -----------------------------------------------------------


def _gloo(mesh: Mesh) -> bool:
    return dist.get_backend(mesh.group) == "gloo"


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t as the transport takes it: contiguous, in host memory under gloo."""
    t = t.contiguous()
    return t.cpu() if t.is_cuda and _gloo(mesh) else t


def _exchange(mesh: Mesh, like: torch.Tensor, dim: int,
              sends: Sequence[Tuple[int, torch.Tensor]],
              recvs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Post this rank's sends `(peer, tensor)` and receives `(peer, rows)`
    (tensors shaped as `like` with `rows` along `dim`) together, both
    directions at once so that no rank waits on another's order, and wait
    for them.  Returns the received tensors on `like`'s device."""
    staged = like.is_cuda and _gloo(mesh)
    ops, bufs = [], []
    for peer, rows in recvs:
        shape = list(like.shape)
        shape[dim] = rows
        buf = torch.empty(shape, dtype=like.dtype, device="cpu" if staged else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, _wire(mesh, t), peer, mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b in bufs]


def _gather(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's equal band of x concatenated along `dim` (an
    all-gather), on x's device."""
    if mesh.size == 1:
        return x
    part = _wire(mesh, x)
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    dist.all_gather(parts, part, group=mesh.group)
    return torch.cat(parts, dim).to(x.device)


def _all_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks, in place."""
    if mesh.size > 1:
        wire = _wire(mesh, t)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
        if wire is not t:
            t.copy_(wire)
    return t


def _fill(like: torch.Tensor, dim: int, rows: int, fill) -> torch.Tensor:
    shape = list(like.shape)
    shape[dim] = rows
    return like.new_full(shape, fill)


def _rows(mesh: Mesh, x: torch.Tensor, dim: int,
          need: Callable[[int], Tuple[int, int]], fill="zero") -> torch.Tensor:
    """The global rows [lo, hi) = `need(rank)` of the map whose equal bands
    along `dim` the ranks hold (x this rank's).  Rows beyond the map are
    `fill`: zeros ("zero"), the edge row repeated ("edge") or a value.  The
    rows come from the neighbours where each rank's need reaches no further
    than its neighbours' bands, else from the whole map, all-gathered.
    Every rank calls it with the same `need`, a function of the rank."""
    hl = x.shape[dim]
    hg, r = hl * mesh.size, mesh.rank

    def reach(q):                     # rows rank q takes from above, from below
        lo, hi = need(q)
        return max(0, q * hl - max(lo, 0)), max(0, min(hi, hg) - (q + 1) * hl)

    reaches = [reach(q) for q in range(mesh.size)]
    lo, hi = need(r)
    if any(a > hl or b > hl for a, b in reaches):
        first, core = 0, _gather(mesh, x, dim)
    else:
        above, below = reaches[r]
        sends = []
        if r > 0 and reaches[r - 1][1]:
            sends.append((r - 1, x.narrow(dim, 0, reaches[r - 1][1])))
        if r + 1 < mesh.size and reaches[r + 1][0]:
            n = reaches[r + 1][0]
            sends.append((r + 1, x.narrow(dim, hl - n, n)))
        recvs = ([(r - 1, above)] if above else []) + ([(r + 1, below)] if below else [])
        got = _exchange(mesh, x, dim, sends, recvs)
        parts = got[:1] * bool(above) + [x] + got[-1:] * bool(below)
        first, core = r * hl - above, torch.cat(parts, dim) if len(parts) > 1 else x
    a, b = max(lo, 0), min(hi, hg)
    core = core.narrow(dim, a - first, b - a)
    top, bottom = max(0, -lo), max(0, hi - hg)
    if top or bottom:
        if fill == "edge":
            parts = [core.narrow(dim, 0, 1).expand(*[top if d == dim else -1
                                                     for d in range(core.dim())]),
                     core, core.narrow(dim, b - a - 1, 1).expand(
                         *[bottom if d == dim else -1 for d in range(core.dim())])]
        else:
            value = 0 if fill == "zero" else fill
            parts = [_fill(core, dim, top, value), core, _fill(core, dim, bottom, value)]
        core = torch.cat(parts, dim)
    return core


def _halo_rows(mesh: Mesh, x: torch.Tensor, dim: int, halo: int):
    """(the `halo` rows above this rank's band x along `dim`, those below
    it; at most a band's): the neighbours' edge rows in one exchange, zeros
    beyond the image."""
    hl = x.shape[dim]
    r, up, down = mesh.rank, mesh.rank > 0, mesh.rank + 1 < mesh.size
    got = _exchange(mesh, x, dim,
                    [(r - 1, x.narrow(dim, 0, halo))] * up
                    + [(r + 1, x.narrow(dim, hl - halo, halo))] * down,
                    [(r - 1, halo)] * up + [(r + 1, halo)] * down)
    above = got.pop(0) if up else _fill(x, dim, halo, 0)
    below = got.pop(0) if down else _fill(x, dim, halo, 0)
    return above, below


# the tensor a stencil's band was cut from, with `halo` rows of room on
# either side: the next stencil writes its halo there instead of copying
_ROOM = "_spatial_room"


def _haloed(mesh: Mesh, x: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    """x with `halo` rows of the neighbours' (zeros beyond the image) on
    either side along `dim`: written into the room x was cut from where it
    has some (no copy of x), else concatenated."""
    above, below = _halo_rows(mesh, x, dim, halo)
    room = getattr(x, _ROOM, None)
    hl = x.shape[dim]
    if room is not None and room.shape[dim] == hl + 2 * halo:
        room.narrow(dim, 0, halo).copy_(above)
        room.narrow(dim, hl + halo, halo).copy_(below)
        return room
    return torch.cat([above, x, below], dim)


def _with_room(y: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    """This rank's rows of a stencil's result y on a band haloed by `halo`
    rows, keeping y as its room."""
    out = y.narrow(dim, halo, y.shape[dim] - 2 * halo)
    setattr(out, _ROOM, y)
    return out


# ---- the public functions ---------------------------------------------------


def halo_exchange(x_local: torch.Tensor, halo: int, mesh: Mesh, mode: str = "zero",
                  dim: int = 0) -> torch.Tensor:
    """This rank's band `x_local` with `halo` rows of each neighbour's on
    either side along `dim` (JAX's layout [H_local, W, C]: dim 0; NCHW
    maps: dim 2).  Beyond the image the first and last ranks get zeros
    ("zero", a SAME convolution's padding) or their edge row repeated
    ("edge", what a bilinear resize's clamped coordinates read).  Returns
    H_local + 2 * halo rows.  Every rank of the mesh must call it."""
    if mode not in ("zero", "edge"):
        raise ValueError(f"unknown halo mode {mode!r}")
    hl = x_local.shape[dim]
    return _rows(mesh, x_local, dim, lambda q: (q * hl - halo, (q + 1) * hl + halo), mode)


def shard_image_h(image: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of a whole image [H, W, C], on
    `mesh.device`.  Raises `ValueError` when H does not split into
    `mesh.size` equal bands."""
    h = image.shape[0]
    if h % mesh.size:
        raise ValueError(f"H = {h} does not split over {mesh.size} ranks")
    hl = h // mesh.size
    return image[mesh.rank * hl:(mesh.rank + 1) * hl].to(mesh.device)


def gather_image_h(y_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image [H, W, C] again from every rank's band (an
    all-gather along H), on every rank."""
    return _gather(mesh, y_local, 0)


def make_spatial_conv3x3(mesh: Mesh) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """`fn(x_local [H_local, W, Cin], w [3, 3, Cin, Cout] HWIO) -> [H_local,
    W, Cout]`: the SAME 3x3 convolution of the whole image, this rank's
    rows, in x's dtype.  K2 (scale 1, shift 0, no ReLU) runs on the band
    haloed by one row (the `f32` kernel in fp32, `wgmma`/`smallc` in bf16;
    its plain version on the CPU); its own padding on H touches only the
    two halo rows, which are dropped."""

    def conv(x_local: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xh = halo_exchange(x_local, 1, mesh)
        cout = w.shape[3]
        ones = torch.ones(cout, dtype=torch.float32, device=xh.device)
        y = fused_conv3x3_bn_relu(xh[None].contiguous(), w.to(xh.device), ones,
                                  torch.zeros_like(ones), relu=False)
        return y[0, 1:-1]

    return conv


def make_spatial_basic_unet(mesh: Mesh) -> Callable:
    """`fn(model, x_local [H_local, W, 3]) -> [H_local, W, classes]` (fp32)
    for the port's `BasicUNet` in eval mode, written out as the JAX package
    writes it: every ConvBNAct is K2 on the band haloed by one row (its
    weights packed once, as the model's own forward packs them), the 2x2
    pools are local, each bilinear 2x upsample exchanges one row in "edge"
    mode (weights 0.25 / 0.75, lerps in fp32, one cast), the
    concatenations and the 1x1 head are local.  H_local must be a multiple
    of 8 (three pools); else `ValueError`."""

    def fwd(model, x_local: torch.Tensor) -> torch.Tensor:
        if x_local.shape[0] % 8:
            raise ValueError(f"H_local = {x_local.shape[0]} is not a multiple of 8")
        dt, dev = model.dtype, mesh.device

        def cba(x, m):
            packed = packed_conv3x3(m[0], m[1], dt, dev)
            y = fused_conv3x3_bn_relu_packed(_haloed(mesh, x, 1, 1).contiguous(), packed,
                                             relu=True)
            return _with_room(y, 1, 1)

        def pool(x):
            n, h, w, c = x.shape
            return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))

        def up(x, out):               # into `out`, in chunks of rows lerped in fp32
            n, h, w, c = x.shape
            xh = halo_exchange(x, 1, mesh, mode="edge", dim=1)
            step = max(1, _CHUNK // (4 * n * w * c))
            for r0 in range(0, h, step):
                r1 = min(h, r0 + step)
                a, b, d = (xh[:, r0 + k:r1 + k].float() for k in range(3))
                y = torch.stack([0.25 * a + 0.75 * b, 0.75 * b + 0.25 * d], 2)
                y = y.reshape(n, 2 * (r1 - r0), w, c)
                yw = torch.cat([y[:, :, :1], y, y[:, :, -1:]], 2)
                a, b, d = yw[:, :, :-2], yw[:, :, 1:-1], yw[:, :, 2:]
                y = torch.stack([0.25 * a + 0.75 * b, 0.75 * b + 0.25 * d], 3)
                out[:, 2 * r0:2 * r1] = y.reshape(n, 2 * (r1 - r0), 2 * w, c)

        def upcat(below, skip, block):
            # the upsample and the skip written side by side into a buffer
            # with a row of room on either side for the first conv's halo
            n, h, w, c = skip.shape
            y = _with_room(torch.empty((n, h + 2, w, below.shape[3] + c), dtype=dt,
                                       device=dev), 1, 1)
            up(below, y[..., :below.shape[3]])
            y[..., below.shape[3]:] = skip
            return cba(cba(y, block[0]), block[1])

        with torch.no_grad():
            x = x_local[None].to(dev, dt)
            e1 = cba(cba(x, model.enc1[0]), model.enc1[1])
            e2 = cba(cba(pool(e1), model.enc2[0]), model.enc2[1])
            e3 = cba(cba(pool(e2), model.enc3[0]), model.enc3[1])
            e4 = cba(cba(pool(e3), model.enc4[0]), model.enc4[1])
            d = upcat(upcat(upcat(e4, e3, model.dec4), e2, model.dec3), e1, model.dec2)
            head = model.head
            logits = F.linear(d, head.weight[:, :, 0, 0].to(dt), head.bias.to(dt))
        return logits[0].float()

    return fwd


def make_spatial_apply(model: torch.nn.Module, mesh: Mesh) -> Callable:
    """`fn(x_local [N, H_local, W, 3]) -> logits [N, H_local, W, C]` (fp32)
    for any model of `get_model` in eval mode: its own forward on this
    rank's band under `SpatialMode`, every stencil's halo exchanged, global
    pools reduced over the ranks.  Every rank calls it with its band of the
    same batch.  H = H_local x size must split so that every stride-2 step
    of the model halves each band exactly while the band holds a row or
    more (H_local a multiple of the model's total stride, or a power of two
    below it, past which the deep maps are held whole on every rank): a
    band that does not raises `ValueError`, on every rank at the same step."""

    def fwd(x_local: torch.Tensor) -> torch.Tensor:
        if model.training:
            raise ValueError("spatial partitioning runs a model in eval mode")
        if x_local.ndim != 4:
            raise ValueError(f"expected [N, H_local, W, C], got {tuple(x_local.shape)}")
        x = _mark(x_local.to(mesh.device).detach(), _NHWC)     # a band with H at dim 1
        with torch.no_grad(), SpatialMode(mesh):
            out = model(x)
        return out[0] if isinstance(out, tuple) else out

    return fwd


# ---- SpatialMode ----------------------------------------------------------

# a tensor's mark: held whole on every rank; a pending pad on H (top,
# bottom, value); rows beyond the bands (a transposed conv's extra rows)
_MARK = "_spatial_mark"
_CHUNK = 1 << 24          # elements of the fp32 rows a resize holds at once
_WHOLE = ("whole",)
_NHWC = ("nhwc",)         # a band with H at dim 1
_SHAPE = torch._C.TensorBase.shape


class _Rows(int):
    """A height read from a map's shape under the mode: a band's (`band`:
    this rank's rows of a map `size` times as tall) or a whole map's.
    Products and exact quotients by plain integers keep the kind; any other
    arithmetic gives a plain int."""

    def __new__(cls, value: int, kind: str):
        rows = super().__new__(cls, value)
        rows.kind = kind
        return rows

    def __mul__(self, other):
        return _Rows(int(self) * other, self.kind) if type(other) is int else int(self) * other

    __rmul__ = __mul__

    def __floordiv__(self, other):
        if type(other) is int and other > 0 and int(self) % other == 0:
            return _Rows(int(self) // other, self.kind)
        return int(self) // other

    __repr__ = __str__ = int.__repr__


def _tag(t) -> Optional[tuple]:
    return getattr(t, _MARK, None) if isinstance(t, torch.Tensor) else None


def _mark(t, tag):
    if isinstance(t, torch.Tensor):
        setattr(t, _MARK, tag)
    elif isinstance(t, (tuple, list)):
        for u in t:
            _mark(u, tag)
    return t


def _is_map(t) -> bool:
    """A 4-D NCHW tensor."""
    return isinstance(t, torch.Tensor) and t.dim() == 4


def _hdim(t) -> Optional[int]:
    """The dim of a band's H (2 in NCHW, 1 marked NHWC); None for what is
    no band or carries another mark."""
    if not _is_map(t):
        return None
    tag = _tag(t)
    return 2 if tag is None else 1 if tag == _NHWC else None


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _replace(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_replace(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _replace(v, fn) for k, v in obj.items()}
    return obj


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, (int, float)) else (int(v[0]), int(v[1]))


def _args(args, kwargs, names, defaults):
    """Positional and keyword arguments by name."""
    out = dict(zip(names, defaults))
    out.update(zip(names, args))
    out.update(kwargs)
    return out


def _same(h: int, ext: int, s: int) -> Tuple[int, int]:
    """TF/XLA SAME padding (top, bottom) of h rows for a window of ext rows
    at stride s."""
    p = max((math.ceil(h / s) - 1) * s + ext - h, 0)
    return p // 2, p - p // 2


def _format(x: torch.Tensor) -> torch.memory_format:
    """x's memory format, for a result of its shape class."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _name(func) -> str:
    return getattr(func, "__name__", "") or ""


# operations that neither read nor move along H, on any operand
_LOCAL = frozenset("""
    add add_ sub sub_ mul mul_ div div_ true_divide neg abs pow square sqrt rsqrt exp log
    relu relu_ sigmoid sigmoid_ silu gelu tanh erf clamp clamp_ clamp_min clamp_max
    where minimum maximum floor ceil round sign eq ne lt le gt ge logical_and logical_or
    logical_not __add__ __radd__ __iadd__ __sub__ __rsub__ __isub__ __mul__ __rmul__
    __imul__ __truediv__ __rtruediv__ __itruediv__ __neg__ __pow__ __rpow__ __eq__ __ne__
    __lt__ __le__ __gt__ __ge__ __and__ __or__ __invert__
    to float double half bfloat16 type type_as contiguous clone detach copy_ fill_ zero_
    ones_like zeros_like empty_like full_like one_hot batch_norm expand_as dropout
""".split())
# layout operations that keep a pending mark (a pad, rows beyond the bands)
_LAYOUT = frozenset("to float double half bfloat16 type type_as contiguous clone detach".split())
# queries of a tensor's metadata
_META = frozenset("""
    __get__ __set__ dim size numel nelement element_size is_contiguous data_ptr stride
    storage_offset ndimension get_device is_floating_point is_complex __len__ __repr__
    __format__ __hash__ item tolist untyped_storage __bool__
""".split())
# reductions along a `dim`
_REDUCE = frozenset("""
    sum mean amax amin argmax argmin max min softmax log_softmax logsumexp prod std var
    norm cumsum cumprod any all sort argsort topk
""".split())


class SpatialMode(TorchFunctionMode):
    """Run a model's forward on this rank's band of rows of maps split
    along H over `mesh` (the module docstring gives the rules).  While it
    is active, `ops.bands.active()` is this mode, for K2 and K1."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        self._suspended = 0
        self._rules = {
            torch.conv2d: self._conv2d, F.conv2d: self._conv2d,
            torch.conv_transpose2d: self._conv_transpose2d,
            F.conv_transpose2d: self._conv_transpose2d,
            F.max_pool2d: self._max_pool2d, torch.max_pool2d: self._max_pool2d,
            F.pad: self._pad, torch._C._nn.pad: self._pad,
            F.interpolate: self._interpolate,
            F.adaptive_avg_pool2d: self._adaptive_avg_pool2d,
            torch.cat: self._cat, torch.concat: self._cat,
        }
        self._method_rules = {"__getitem__": self._getitem, "reshape": self._reshape,
                              "view": self._reshape, "expand": self._expand,
                              "permute": self._permute}

    # -- entering and leaving, suspension -----------------------------------

    def __enter__(self):
        bands._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        bands._ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def suspended(self):
        """Run code that sees the band as an ordinary tensor."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # -- geometry -------------------------------------------------------------

    def _own(self, t: torch.Tensor, hl: int) -> torch.Tensor:
        """This rank's rows of a map held whole, to meet bands of hl rows."""
        h = t.shape[2]
        if h == 1:
            return t                                      # broadcasts along H
        if h != hl * self.mesh.size:
            # a size read from a map held whole taken as a band's: the maps
            # below one row a band reach a layer that resizes to them
            raise ValueError(
                f"spatial partitioning: a map held whole ({h} rows) meets bands of {hl} "
                f"rows: the input has too few rows for {self.mesh.size} ranks here (H / "
                "ranks below the model's total stride)")
        return t[:, :, self.mesh.rank * hl:(self.mesh.rank + 1) * hl]

    def _split(self, hl: int, s: int, what: str) -> bool:
        """Whether a stride-s step keeps bands of hl rows split (else the
        output is held whole: a band below s rows); `ValueError` where a
        band of s rows or more does not halve exactly."""
        if hl % s == 0:
            return True
        if hl < s:
            return False
        raise ValueError(f"spatial partitioning: {what} at stride {s} does not split "
                         f"bands of {hl} rows (a map of {hl * self.mesh.size} rows over "
                         f"{self.mesh.size} ranks)")

    def _window_op(self, x, ext: int, s: int, pad: Tuple[int, int], fill, op, what: str):
        """A window of ext rows at stride s over x padded by pad = (top,
        bottom) with `fill` (a pending pad included): `op(rows)` of the rows
        each output row reads, with no padding on H."""
        hl = x.shape[2]
        hg = hl * self.mesh.size
        pt, pb = pad
        ho = (hg + pt + pb - ext) // s + 1
        if self._split(hl, s, what) and ho == self.mesh.size * (hl // s):
            hol = hl // s
            slab = _rows(self.mesh, x, 2,
                         lambda q: (q * hol * s - pt, ((q + 1) * hol - 1) * s - pt + ext), fill)
            return op(slab)
        whole = _gather(self.mesh, x, 2)
        value = 0 if fill == "zero" else fill
        whole = torch.cat([_fill(whole, 2, pt, value), whole, _fill(whole, 2, pb, value)], 2)
        return _mark(op(whole), _WHOLE)

    def _pending_pad(self, x, hl, ext, s, pad, what):
        """The H padding and fill of a stencil over x: its own `pad` plus a
        pending `F.pad`, that one from the whole map's height where it was
        the SAME padding of the band's."""
        tag = _tag(x)
        if tag is None:
            return pad, "zero"
        if tag[0] != "pad":
            raise NotImplementedError(f"spatial partitioning: {what} of a band marked "
                                      f"{tag[0]}")
        _, top, bottom, value = tag
        if (top, bottom) == _same(hl, ext, s):
            top, bottom = _same(hl * self.mesh.size, ext, s)
        if value != 0 and pad != (0, 0):
            raise NotImplementedError(f"spatial partitioning: {what} pads a padded band "
                                      "with another value")
        return (pad[0] + top, pad[1] + bottom), value

    # -- the rules -------------------------------------------------------------

    def _conv2d(self, func, args, kwargs):
        a = _args(args, kwargs, ("input", "weight", "bias", "stride", "padding", "dilation",
                                 "groups"), (None, None, None, 1, 0, 1, 1))
        x, w = a["input"], a["weight"]
        if _tag(x) == _WHOLE:
            return _mark(func(*args, **kwargs), _WHOLE)
        if not _is_map(x):
            return func(*args, **kwargs)
        (sh, sw), (dh, dw) = _pair(a["stride"]), _pair(a["dilation"])
        kh = w.shape[2]
        ext = (kh - 1) * dh + 1
        if isinstance(a["padding"], str):
            raise NotImplementedError(f"spatial partitioning: conv2d padding={a['padding']!r}")
        ph, pw = _pair(a["padding"])
        hl = x.shape[2]
        pad, fill = self._pending_pad(x, hl, ext, sh, (ph, ph), "conv2d")
        if kh == 1 and sh == 1 and pad == (0, 0):
            return func(x, w, a["bias"], a["stride"], (0, pw), a["dilation"], a["groups"])
        return self._window_op(
            x, ext, sh, pad, fill,
            lambda rows: func(rows, w, a["bias"], (sh, sw), (0, pw), (dh, dw), a["groups"]),
            "conv2d")

    def _conv_transpose2d(self, func, args, kwargs):
        a = _args(args, kwargs, ("input", "weight", "bias", "stride", "padding",
                                 "output_padding", "groups", "dilation"),
                  (None, None, None, 1, 0, 0, 1, 1))
        x, w = a["input"], a["weight"]
        if _tag(x) == _WHOLE:
            return _mark(func(*args, **kwargs), _WHOLE)
        if not _is_map(x):
            return func(*args, **kwargs)
        if _tag(x) is not None:
            raise NotImplementedError("spatial partitioning: conv_transpose2d of a marked band")
        (s, sw), (ph, pw) = _pair(a["stride"]), _pair(a["padding"])
        (oph, opw), (dh, dw) = _pair(a["output_padding"]), _pair(a["dilation"])
        ext = (w.shape[2] - 1) * dh + 1
        hl = x.shape[2]
        hg, size = hl * self.mesh.size, self.mesh.size
        hol = hl * s
        extra = (hg - 1) * s - 2 * ph + ext + oph - size * hol
        if extra < 0:
            raise NotImplementedError("spatial partitioning: conv_transpose2d whose output "
                                      "has fewer rows than its bands")

        def need(q):                  # input rows i with i * s - ph + k * dh in the band
            return (-(-(q * hol + ph - (ext - 1)) // s), ((q + 1) * hol - 1 + ph) // s + 1)

        lo, _ = need(self.mesh.rank)
        slab = _rows(self.mesh, x, 2, need)
        y = func(slab, w, a["bias"], (s, sw), (0, pw), (0, opw), a["groups"], (dh, dw))
        j0 = self.mesh.rank * hol - lo * s + ph
        if j0 < 0 or j0 + hol > y.shape[2]:
            raise NotImplementedError("spatial partitioning: conv_transpose2d with this "
                                      "kernel, stride and padding")
        y = y[:, :, j0:j0 + hol]
        return _mark(y, ("extra", extra)) if extra else y

    def _max_pool2d(self, func, args, kwargs):
        a = _args(args, kwargs, ("input", "kernel_size", "stride", "padding", "dilation",
                                 "ceil_mode", "return_indices"),
                  (None, None, None, 0, 1, False, False))
        x = a["input"]
        if _tag(x) == _WHOLE or not _is_map(x):
            return self._local(func, args, kwargs)
        if a["ceil_mode"] or a["return_indices"]:
            raise NotImplementedError("spatial partitioning: max_pool2d with ceil_mode or "
                                      "return_indices")
        (kh, kw) = _pair(a["kernel_size"])
        (sh, sw) = _pair(a["stride"] if a["stride"] not in (None, []) else a["kernel_size"])
        (ph, pw), (dh, dw) = _pair(a["padding"]), _pair(a["dilation"])
        ext = (kh - 1) * dh + 1
        hl = x.shape[2]
        if _tag(x) is not None:
            raise NotImplementedError("spatial partitioning: max_pool2d of a marked band")
        if ext == sh and ph == 0 and hl % sh == 0:
            return func(x, (kh, kw), (sh, sw), (0, pw), (dh, dw))
        return self._window_op(
            x, ext, sh, (ph, ph), float("-inf"),
            lambda rows: func(rows, (kh, kw), (sh, sw), (0, pw), (dh, dw)), "max_pool2d")

    def _pad(self, func, args, kwargs):
        a = _args(args, kwargs, ("input", "pad", "mode", "value"), (None, None, "constant", None))
        x, pad = a["input"], list(a["pad"])
        if _tag(x) == _WHOLE or not _is_map(x) or len(pad) < 4 or pad[2:4] == [0, 0]:
            return self._local(func, args, kwargs)
        if len(pad) > 4 or a["mode"] != "constant" or min(pad[2:4]) < 0 or _tag(x) is not None:
            raise NotImplementedError("spatial partitioning: F.pad of a band other than a "
                                      "constant pad of H and W")
        value = 0.0 if a["value"] is None else a["value"]
        y = func(x, pad[:2], "constant", value) if pad[:2] != [0, 0] else x.view_as(x)
        return _mark(y, ("pad", pad[2], pad[3], value))

    def _interpolate(self, func, args, kwargs):
        a = _args(args, kwargs, ("input", "size", "scale_factor", "mode", "align_corners",
                                 "recompute_scale_factor", "antialias"),
                  (None, None, None, "nearest", None, None, False))
        x, mode = a["input"], a["mode"]
        tag = _tag(x)
        if not _is_map(x) and tag is None:
            return self._local(func, args, kwargs)
        if (mode not in ("nearest", "bilinear") or a["antialias"] or a["recompute_scale_factor"]
                or tag not in (None, _WHOLE)):
            raise NotImplementedError(f"spatial partitioning: interpolate mode={mode} of "
                                      "this band")
        size = self.mesh.size
        hin = x.shape[2] * (1 if tag == _WHOLE else size)
        win = x.shape[3]
        sf = None if a["scale_factor"] is None else (
            (float(a["scale_factor"]),) * 2 if isinstance(a["scale_factor"], (int, float))
            else tuple(float(v) for v in a["scale_factor"]))
        if a["size"] is not None:
            oh = a["size"] if isinstance(a["size"], int) else a["size"][0]
            ow = _pair(a["size"])[1]
            kind = getattr(oh, "kind", None)
            if kind is None:
                raise NotImplementedError(
                    f"spatial partitioning: interpolate to {int(oh)} rows, a height read "
                    "from no map's shape")
            hout = int(oh) * (size if kind == "band" else 1)
        else:
            hout, ow = int(math.floor(hin * sf[0])), int(math.floor(win * sf[1]))
        banded = hout % size == 0
        hol = hout // size if banded else hout
        first = self.mesh.rank * hol if banded else 0
        corners = bool(a["align_corners"])
        src = _source_rows(hin, hout, mode, corners, None if sf is None else sf[0])
        i0, i1, l1 = (t[first:first + hol] for t in src)

        def need(q):
            j0, j1, _ = (t[q * hol:(q + 1) * hol] if banded else t for t in src)
            return int(j0.min()), int(j1.max()) + 1

        lo, hi = need(self.mesh.rank)
        slab = x[:, :, lo:hi] if tag == _WHOLE else _rows(self.mesh, x, 2, need)
        n, c = x.shape[:2]
        out = torch.empty((n, c, hol, ow), dtype=x.dtype, device=x.device,
                          memory_format=_format(x))
        # output rows in chunks, so that the fp32 rows in flight stay small
        step = max(1, _CHUNK // max(1, n * c * ow))
        for a0 in range(0, hol, step):
            j0, j1, lam = i0[a0:a0 + step], i1[a0:a0 + step], l1[a0:a0 + step]
            s0, s1 = int(j0.min()), int(j1.max()) + 1
            rows = slab[:, :, s0 - lo:s1 - lo]
            if mode == "bilinear":
                rows = rows.float()
            wkw = dict(scale_factor=(1.0, sf[1])) if a["size"] is None else dict(
                size=(s1 - s0, ow))
            rows = func(rows, mode=mode, align_corners=a["align_corners"], **wkw)
            part = rows.index_select(2, (j0 - s0).to(x.device))
            if mode == "bilinear":
                part.mul_((1 - lam).view(1, 1, -1, 1).to(x.device))
                part.addcmul_(rows.index_select(2, (j1 - s0).to(x.device)),
                              lam.view(1, 1, -1, 1).to(x.device))
            out[:, :, a0:a0 + step] = part
        return out if banded else _mark(out, _WHOLE)

    def _adaptive_avg_pool2d(self, func, args, kwargs):
        a = _args(args, kwargs, ("input", "output_size"), (None, None))
        x = a["input"]
        if _tag(x) == _WHOLE or not _is_map(x):
            return self._local(func, args, kwargs)
        if _tag(x) is not None:
            raise NotImplementedError("spatial partitioning: adaptive_avg_pool2d of a "
                                      "marked band")
        n, c, hl, w = x.shape
        out = a["output_size"]
        oh, ow = (out, out) if isinstance(out, int) else out
        hg = hl * self.mesh.size
        oh, ow = hg if oh is None else oh, w if ow is None else ow
        start = self.mesh.rank * hl
        sums = torch.zeros((n, c, oh, ow), dtype=torch.float32, device=x.device)
        counts = torch.zeros((oh, ow), dtype=torch.float32, device=x.device)
        for i in range(oh):
            a0, a1 = i * hg // oh, -(-(i + 1) * hg // oh)
            lo, hi = max(a0, start), min(a1, start + hl)
            for j in range(ow):
                b0, b1 = j * w // ow, -(-(j + 1) * w // ow)
                counts[i, j] = (a1 - a0) * (b1 - b0)
                if lo < hi:
                    sums[:, :, i, j] = x[:, :, lo - start:hi - start, b0:b1].float().sum((2, 3))
        _all_sum_(self.mesh, sums)
        y = (sums / counts).to(x.dtype)
        return _mark(y, _WHOLE) if _is_map(y) else y

    def _cat(self, func, args, kwargs):
        a = _args(args, kwargs, ("tensors", "dim"), (None, 0))
        hdims = {_hdim(t) for t in a["tensors"] if _is_map(t) and _tag(t) != _WHOLE}
        if a["dim"] % 4 in hdims or len(hdims) > 1:
            raise NotImplementedError("spatial partitioning: cat of bands along H")
        return self._local(func, args, kwargs)

    def _getitem(self, func, args, kwargs):
        x, index = args
        tag = _tag(x)
        if not _is_map(x) or tag == _WHOLE:
            return self._local(func, args, kwargs)
        hd = 1 if tag == _NHWC else 2
        index = list(index) if isinstance(index, tuple) else [index]
        at, dims, pos = None, 0, []
        consuming = [e for e in index if e is not None and e is not Ellipsis]
        for k, e in enumerate(index):
            if e is None:
                continue
            if e is Ellipsis:
                dims += x.dim() - len(consuming)
                continue
            if isinstance(e, torch.Tensor) and e.dtype == torch.bool and e.dim() > 1:
                raise NotImplementedError("spatial partitioning: a boolean mask over a band")
            if dims == hd:
                at = k
            dims += 1
            pos.append(k)
        h_index = slice(None) if at is None else index[at]
        if isinstance(h_index, slice) and h_index == slice(None):
            if tag is not None and tag[0] == "pad":
                raise NotImplementedError("spatial partitioning: indexing a padded band")
            y = func(x, tuple(index), **kwargs)
            return _mark(y, tag) if tag is not None and _is_map(y) else y
        if tag is not None and tag[0] == "extra" and isinstance(h_index, slice):
            hb = x.shape[2] * self.mesh.size
            if h_index.indices(hb + tag[1]) == (0, hb, 1):
                index[at] = slice(None)
                return func(x, tuple(index), **kwargs)
        raise NotImplementedError(
            f"spatial partitioning: indexing a band along H with {h_index!r}")

    def _reshape(self, func, args, kwargs):
        x = args[0]
        if not _is_map(x) or _tag(x) == _WHOLE:
            return self._local(func, args, kwargs)
        shape = list(args[1]) if len(args) == 2 and isinstance(args[1], (tuple, list, torch.Size)) \
            else list(args[1:]) or list(kwargs.get("shape", ()))
        if -1 in shape:
            known = math.prod(v for v in shape if v != -1)
            shape[shape.index(-1)] = x.numel() // max(known, 1)
        n, c, hl, w = x.shape
        if shape == [n, c, hl, w] and _tag(x) in (None, _NHWC):
            return _mark(func(*args, **kwargs), _tag(x))
        if _tag(x) is None and len(shape) >= 4 and shape[:2] == [n, c] and shape[2] >= 1:
            k = hl // shape[2] if hl % shape[2] == 0 else 0
            if k == 1 and math.prod(shape[3:]) == w:          # W split, H kept
                return func(*args, **kwargs)
            if k > 1 and len(shape) >= 5 and shape[3] == k and math.prod(shape[4:]) == w:
                return func(*args, **kwargs)  # rows in groups of k inside the band
        raise NotImplementedError(f"spatial partitioning: {_name(func)} of a band to {shape}")

    def _expand(self, func, args, kwargs):
        """A per-image vector (held whole, one row) expanded to a size read
        from a band's shape is that band."""
        x = args[0]
        shape = list(args[1]) if len(args) == 2 and isinstance(args[1], (tuple, list, torch.Size)) \
            else list(args[1:]) or list(kwargs.get("size", ()))
        if _tag(x) == _WHOLE and x.dim() == 4 and x.shape[2] == 1 and len(shape) == 4 \
                and getattr(shape[2], "kind", None) == "band":
            return func(*args, **kwargs)
        return self._local(func, args, kwargs)

    def _permute(self, func, args, kwargs):
        """A permute that keeps a band's H at dim 2 or moves it between dims
        2 and 1 (NCHW and NHWC)."""
        x = args[0]
        hd = _hdim(x)
        if hd is None:
            return self._local(func, args, kwargs)
        dims = args[1] if len(args) == 2 and isinstance(args[1], (tuple, list)) else (
            args[1:] or kwargs["dims"])
        at = [d % 4 for d in dims].index(hd)
        if at not in (1, 2):
            raise NotImplementedError(f"spatial partitioning: permute moves a band's H to "
                                      f"dim {at}")
        return _mark(func(*args, **kwargs), None if at == 2 else _NHWC)

    def _reduce(self, func, args, kwargs):
        name = _name(func)
        x = args[0] if args else kwargs.get("input")
        if not _is_map(x) or _tag(x) == _WHOLE:
            return self._local(func, args, kwargs)
        hd = _hdim(x)
        a = _args(args[1:], {k: v for k, v in kwargs.items() if k != "input"},
                  ("dim", "keepdim"), (None, False))
        dims = a["dim"]
        dims = tuple(range(4)) if dims is None else (
            (dims,) if isinstance(dims, int) else tuple(dims))
        dims = tuple(d % 4 for d in dims)
        if hd is not None and hd not in dims:
            y = func(*args, **kwargs)
            return _mark(y, _tag(x)) if _is_map(y) else y
        if name not in ("sum", "mean") or hd != 2 or "dtype" in kwargs:
            raise NotImplementedError(f"spatial partitioning: {name} of a band along H")
        s = _all_sum_(self.mesh, torch.sum(x, dim=dims, keepdim=bool(a["keepdim"]),
                                           dtype=torch.float32))
        if name == "mean":
            s = s / math.prod(x.shape[d] * (self.mesh.size if d == 2 else 1) for d in dims)
        s = s.to(x.dtype)
        return _mark(s, _WHOLE) if _is_map(s) else s

    def _local(self, func, args, kwargs):
        """An operation computed on each rank's operands as they are: a
        map held whole meets a band as the band's rows; a result of maps
        held whole only is held whole."""
        tensors = _tensors((args, kwargs))
        tags = [_tag(t) for t in tensors]
        if _NHWC in tags:             # NHWC bands alone: the result is one
            if any(_is_map(t) and g != _NHWC for t, g in zip(tensors, tags)):
                raise NotImplementedError(f"spatial partitioning: {_name(func)} of an NHWC "
                                          "band with another map")
            y = func(*args, **kwargs)
            return _mark(y, _NHWC) if _is_map(y) else y
        pending = [t for t in tags if t is not None and t != _WHOLE]
        if pending:
            if _name(func) in _LAYOUT and len(tensors) == 1:
                return _mark(func(*args, **kwargs), pending[0])
            raise NotImplementedError(f"spatial partitioning: {_name(func)} of a band with a "
                                      f"pending {pending[0][0]}")
        if _WHOLE not in tags:
            return func(*args, **kwargs)
        banded = [t for t, g in zip(tensors, tags) if _is_map(t) and g is None]
        if not banded:
            return _mark(func(*args, **kwargs), _WHOLE)
        hl = banded[0].shape[2]
        args, kwargs = _replace((args, kwargs), lambda t: self._own(t, hl)
                                if _tag(t) == _WHOLE and t.dim() == 4 else t)
        return func(*args, **kwargs)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suspended:
            return func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is not None:
            return rule(func, args, kwargs)
        name = _name(func)
        if name in self._method_rules:
            return self._method_rules[name](func, args, kwargs)
        if name in _META:
            out = func(*args, **kwargs)
            if name == "size" or getattr(func, "__self__", None) is _SHAPE:
                out = self._read(args[0], args[1:], out)
            return out
        if name in _REDUCE:
            return self._reduce(func, args, kwargs)
        if name in _LOCAL:
            return self._local(func, args, kwargs)
        if any(_is_map(t) and _tag(t) != _WHOLE for t in _tensors((args, kwargs))):
            raise NotImplementedError(
                f"spatial partitioning has no rule for {name or func!r} on a band of rows")
        return self._local(func, args, kwargs)

    def _read(self, x, dim, out):
        """A shape read of x (`shape`, `size()` or `size(dim)`) with its
        height a `_Rows`."""
        hd = 2 if _tag(x) == _WHOLE and _is_map(x) else _hdim(x)
        if hd is None:
            return out
        kind = "whole" if _tag(x) == _WHOLE else "band"
        if isinstance(out, torch.Size):
            return torch.Size([_Rows(v, kind) if d == hd else v for d, v in enumerate(out)])
        return _Rows(out, kind) if dim and dim[0] % 4 == hd else out

    # -- the fused kernels' hook (ops.bands) ---------------------------------

    def stencil(self, x: torch.Tensor, halo: int, fn) -> torch.Tensor:
        """`fn(xh, own)` of this rank's band x haloed by `halo` rows (at
        most a band's; zeros beyond the image), `own` the `ops.bands.Own` of
        xh; this rank's rows of its result, which keeps the result as room
        for the next stencil's halo.  A map held whole goes in and comes out
        whole."""
        tag = _tag(x)
        with self.suspended():
            hl = x.shape[2]
            if tag == _WHOLE:
                own = bands.Own((0, hl), lambda t: None, hl * x.shape[3])
                return _mark(fn(x, own), _WHOLE)
            if tag is not None:
                raise NotImplementedError("spatial partitioning: a fused kernel on a "
                                          "marked band")
            own = bands.Own((halo, halo + hl), lambda t: _all_sum_(self.mesh, t),
                            hl * self.mesh.size * x.shape[3])
            return _with_room(fn(_haloed(self.mesh, x, 2, halo), own), 2, halo)


def _source_rows(hin: int, hout: int, mode: str, align_corners: bool,
                 scale_factor: Optional[float]) -> Tuple[torch.Tensor, ...]:
    """For each of hout output rows, PyTorch's source rows i0, i1 and the
    weight of i1 (ATen's `UpSample.h`: `area_pixel_compute_scale`,
    `area_pixel_compute_source_index` and `nearest_idx`, in fp32 as its
    kernels compute them), on the host."""
    f32 = torch.float32
    o = torch.arange(hout, dtype=f32)

    def ratio(num, den):              # a float division, as ATen's
        return torch.tensor(num, dtype=f32) / torch.tensor(den, dtype=f32)

    def scale():                      # compute_scales_value
        return (torch.tensor(1.0 / scale_factor, dtype=f32) if scale_factor
                else ratio(hin, hout))

    if mode == "nearest":
        if hout == hin:
            i0 = torch.arange(hout)
        elif hout == 2 * hin:
            i0 = torch.arange(hout) // 2
        else:
            i0 = torch.clamp((o * scale()).floor().long(), max=hin - 1)
        return i0, i0, torch.zeros(hout)
    if hout == hin:
        i0 = torch.arange(hout)
        return i0, i0, torch.zeros(hout)
    if align_corners:
        src = (ratio(hin - 1, hout - 1) if hout > 1 else torch.tensor(0.0)) * o
    else:
        src = torch.clamp(scale() * (o + 0.5) - 0.5, min=0.0)
    i0 = src.floor().long()
    i1 = torch.clamp(i0 + 1, max=hin - 1)
    return i0, i1, torch.clamp(src - i0.to(f32), 0.0, 1.0)
