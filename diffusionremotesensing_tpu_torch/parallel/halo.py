"""Halo exchanges of spatial partitioning (``parallel.sharding.spatial_sharding``).

One image's height is split into equal bands over a mesh; each band runs the
UNet on its own rows. The JAX package leaves the convolutions' halos to
XLA's SPMD partitioner; here every exchange is written out, by one rule
that keeps the model code and the hand-written kernels unchanged:

1. at each exchange point ("site") a band is extended toward its
   neighbours only, by the rows the chain of ops up to the next site reads
   beyond its own (the site's halo, ``HALOS``), taken from the neighbour
   bands;
2. the chain runs as it is on the extended band, each op with its own zero
   padding, each kernel unmodified;
3. the chain's outputs are cropped back to the band (a site whose output is
   at another level crops in that level's rows: twice the rows after a
   ConvTranspose, half after a stride-2 conv).

At the image's true top and bottom nothing is added, so the zero padding,
the bicubic's edge clamp, the head's bias frame (``_bias_frame`` zeroes the
ConvTranspose bias on the first and last rows) and its row-0 corrections
(on ``hh_row0``, the extended band's first row) are right there without a
special case; on an inner band they land on halo rows, which the crop drops.
The extended rows a chain computes wrongly (those within its radius of the
extended band's edge) are exactly the rows cropped, so a halo one row short
leaves a wrong row at each seam: ``tests/test_torch_port_spatial.py``
checks that the seams see it.

The halos, in rows of the site's input level (level l has H / 2^l rows, the
s2d grid of level 0 "0s" H / 2, the LR condition H / mag), worked out from
``models/unet.py``, ``models/blocks.py`` and the kernels' convolutions:

===========  ===================  ==========  ===================================================
site         level (input rows)   (above,     the chain up to the next site
                                  below)
===========  ===================  ==========  ===================================================
encoder      LR (H/mag); SAR: H   (7, 7)      RRDB: 3 residual blocks of two 3x3 convs, conv_out
cond_up      LR                   (2, 2)      x mag bicubic (output row o reads floor(s)-1 ..
                                              floor(s)+2, s = (o + 0.5) / mag - 0.5: 2 LR rows
                                              each side of the band for rows -1 .. band + 1 at
                                              HR), then the 3x3 condition conv at HR
cond_conv    H (SAR)              (1, 1)      the 3x3 condition conv
stem         0 (H)                (3, 3)      conv0 3x3 (+ condition), ResConvBlock-0: conv1 3x3
                                              (skip 3x3 beside it), conv2 3x3, shortcut 1x1
stem_s2d     0s (H/2)             (2, 2)      the same three 3x3 convs re-blocked on the s2d grid
                                              (tap_stem_block, conv0 + tap_block, or the dense s2d
                                              convs): 3 rows at H are 1.5 s2d rows, so 2
down         l -> l+1 (l = 0..2)  (2, 0)      3x3 stride 2, padding 1: output row j reads 2j-1 ..
                                              2j+1, one row above; 2 keep the extended band on an
                                              even row, crop 1 at l+1
down0_s2d    0s -> 1              (1, 0)      down0 on the s2d grid: 2x2 with padding (1, 0)
down0s       0s -> 1s ('l1')      (2, 0)      down0 emitting level 1 in s2d (H/4 rows): 3x3
                                              stride 2, padding (1, 0): output row m reads 0s
                                              rows 2m-1 .. 2m+1, one above; 2 keep the extended
                                              band on an even row, crop 1 at 1s
block_s2d    1s ('l1')            (1, 1)      tap_block at level 1 without its skip conv:
                                              conv1 3x3 and conv2 3x3 at level 1, 2 rows of
                                              level 1 each side, one s2d row (the kernel's 4x4
                                              windows leave out the level-1 rows a 3x3 does not
                                              read), shortcut 1x1
down1_s2d    1s -> 2 ('l1')       (1, 0)      down1 on the s2d grid, as down0_s2d
block        1, 2; 3 (bottleneck) (2, 2)      ResConvBlock: conv1 3x3, conv2 3x3, shortcut 1x1
up           3 -> 2, 2 -> 1,      (1, 2)      UpConvBlock: 3x3 conv, then ConvTranspose2x (k3 s2
             1 -> 0                           p1 op1: output 2m reads m, 2m+1 reads m and m+1);
                                              the band doubles, crop (2, 4)
up_conv      2, 1; plain also 0   (1, 1)      the 3x3 concat conv
head         1 = 0s               (3, 4)      s2d tail: up_convs[1] 3x3, UpConvBlock-2's 3x3,
                                              head_up4 4x4 padding ((1, 2), (1, 2)) (dec_block,
                                              or the same convs unfused; more rows below than
                                              above as the kernels read them, though the 4x4's
                                              last tap row is zero in exact arithmetic: the
                                              ConvTranspose's second s2d row feeds odd rows at
                                              H, the head's third reads even ones); beside it
                                              gating 2 and gate 2 (1x1s),
                                              head_at 3x3 (att_head_block or unfused); the row-0
                                              and column-0 corrections and the bias frame, all on
                                              the extended band
gates        -                    none        gating 1x1; w_x 2x2 stride 2 on bands that start on
                                              even rows (H a multiple of 8 x the bands), psi 1x1
                                              upsampled x2 nearest, result 1x1: row for row
                                              ('l1''s s2d gate 1 too: w_x a 1x1 over the taps of
                                              res1_s, psi broadcast over them, result
                                              block-diagonal; g at level 2 has res1_s's rows)
===========  ===================  ==========  ===================================================

``stem_s2d`` and ``head`` need no other halo for the kernels that run
inside them: ``tap_conv_pair`` (conv1 and the skip conv) and ``tap_conv``
(conv2) are the same three 3x3 convolutions at H as ``tap_stem_block`` and
the dense s2d convs, each a 4x4 window of H rows, one s2d row each side;
``packed_head`` is ``head_up4`` (4x4, padding (1, 2)) and ``head_at`` (3x3)
in one call, the head's own convolutions. Each kernel pads with zeros at
its tensor's edge, as its convolutions do at the image's, so on an
extended band it computes the chain's rows as the separate ops would. The
rows they get (:func:`band_row_counts`; first, inner, last band) at HR 512
over 2 and 4 bands: ``tap_conv``/``tap_conv_pair`` 130; 66, 68, 66 of the
256-row s2d grid; ``tap_block`` at level 1 65; 33, 34, 33 of 128;
``packed_head`` 132, 131; 68, 71, 67 of 256: none a multiple of their
8-row tiles, which the kernels count with ceil (and their TMA boxes
zero-fill past the last row).

A band takes a halo from its neighbours alone, so each band must hold at
least a site's halo at that site's level: with H a multiple of 8 x the
bands, the bottleneck's 2 rows at H/8 (H >= 16 x the bands) and the
encoder's 7 LR rows are what bind; a site that finds fewer raises.

The exchange (:class:`LocalLink` between the local devices of one process,
bands run at once on one thread each, threads kept for the process's life
so that cuDNN's per-thread plans stay built, a slice handed over and moved with
``.to(device)``; :class:`RankLink` between the ranks of a process group,
one band a rank, ``dist.batch_isend_irecv`` of the rows, through the host
under gloo) happens inside :meth:`Band.site`; :func:`site` is what the
model calls, a plain call without a band. While a site's chain runs,
:func:`own_rows` gives any tensor of it cut to the band's own rows, so a
statistic taken band by band (the int8 calibration's maximum) reads each
row of the image once and never a halo row; :func:`run_bands` calls a
function on each band's rows of its arguments at once.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# (rows above, rows below) each site reads beyond the band, in rows of its
# input (the table above); read at each call
HALOS = {
    "encoder": (7, 7),
    "cond_up": (2, 2),
    "cond_conv": (1, 1),
    "stem": (3, 3),
    "stem_s2d": (2, 2),
    "down": (2, 0),
    "down0_s2d": (1, 0),
    "down0s": (2, 0),
    "block_s2d": (1, 1),
    "down1_s2d": (1, 0),
    "block": (2, 2),
    "up": (1, 2),
    "up_conv": (1, 1),
    "head": (3, 4),
}


class LocalLink:
    """The exchange between the bands of one process, each on its own
    thread (:meth:`run`): a band posts the rows its neighbours need, waits
    for every band to have posted, and takes its neighbours' rows to its own
    device. Two sets of slots alternate, so that one barrier an exchange
    suffices."""

    def __init__(self, first: int, count: int):
        self.first = first
        self.barrier = threading.Barrier(count)
        self.slots = [[None] * count, [None] * count]
        self.turns = [0] * count

    def swap(self, index: int, sends: dict, recv_like: dict, device) -> dict:
        k = index - self.first
        slots = self.slots[self.turns[k] % 2]
        self.turns[k] += 1
        slots[k] = sends
        self.barrier.wait()
        return {src: [t.to(device) for t in slots[src - self.first][index]] for src in recv_like}

    def run(self, fns: Sequence[Callable]) -> list:
        """Call each band's ``fn`` at once, band i on worker thread i
        (:data:`_WORKERS`), in the caller's grad and inference mode and on
        the caller's current stream of each CUDA device; the results in band
        order. A band that raises breaks the barrier, so the others stop
        too; the first error is raised."""
        if len(fns) == 1:
            return [fns[0]()]
        self.barrier.reset()
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        streams = ([torch.cuda.current_stream(i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
        results, errors = [None] * len(fns), [None] * len(fns)

        def call(i):
            try:
                with contextlib.ExitStack() as ctx:
                    ctx.enter_context(torch.inference_mode(inference))
                    ctx.enter_context(torch.set_grad_enabled(grad))
                    for st in streams:
                        ctx.enter_context(torch.cuda.stream(st))
                    results[i] = fns[i]()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[i] = e
                self.barrier.abort()

        _WORKERS.run([lambda i=i: call(i) for i in range(len(fns))])
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)), None)
        if first is None:
            first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


class _Workers:
    """Threads that live as long as the process, worker i running band i of
    every split: cuDNN keeps its execution plans per thread (PyTorch's
    cache of them is thread-local), so a new thread a step would build
    every convolution's plan again (~120 ms a step of the 512-px image on
    an H100). One split runs at a time."""

    def __init__(self):
        self.lock = threading.Lock()
        self.queues: list = []

    @staticmethod
    def _serve(jobs):
        while True:
            fn, done = jobs.get()
            fn()  # never raises: LocalLink.run's call keeps the error
            done.release()

    def run(self, fns: Sequence[Callable]) -> None:
        with self.lock:
            while len(self.queues) < len(fns):
                jobs = queue.SimpleQueue()
                threading.Thread(target=self._serve, args=(jobs,), daemon=True,
                                 name=f"band-{len(self.queues)}").start()
                self.queues.append(jobs)
            done = threading.Semaphore(0)
            for jobs, fn in zip(self.queues, fns):
                jobs.put((fn, done))
            for _ in fns:
                done.acquire()


_WORKERS = _Workers()


class RankLink:
    """The exchange between the ranks of ``group``, one band a rank: the
    rows go by ``dist.batch_isend_irecv``, one message a tensor, on the
    group's backend as ``parallel.sharding.BACKENDS`` chose it (NCCL
    between cards; under gloo through host copies, which its point-to-point
    calls take)."""

    def __init__(self, group):
        self.group = group
        self.via_host = dist.get_backend(group) != "nccl"

    def _peer(self, band: int) -> int:
        return dist.get_global_rank(self.group, band) if self.group is not dist.group.WORLD \
            else band

    def swap(self, index: int, sends: dict, recv_like: dict, device) -> dict:
        host = torch.device("cpu")
        ops, bufs = [], {}
        for dst, ts in sends.items():
            for tag, t in enumerate(ts):
                t = (t.to(host) if self.via_host else t).contiguous()
                ops.append(dist.P2POp(dist.isend, t, self._peer(dst), self.group, tag))
        for src, likes in recv_like.items():
            bufs[src] = [torch.empty(like.shape, dtype=like.dtype,
                                     device=host if self.via_host else device) for like in likes]
            for tag, b in enumerate(bufs[src]):
                ops.append(dist.P2POp(dist.irecv, b, self._peer(src), self.group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return {src: [b.to(device) for b in bs] for src, bs in bufs.items()}

    def run(self, fns: Sequence[Callable]) -> list:
        return [fn() for fn in fns]


class Band:
    """Band ``index`` of ``count`` equal bands of one image, exchanging its
    halos through ``link`` (:class:`LocalLink` or :class:`RankLink`)."""

    def __init__(self, index: int, count: int, link):
        self.index, self.count, self.link = index, count, link

    def site(self, name: str, fn: Callable, *xs, dims=1, out_dims=None):
        """``fn(*xs)`` on this band's rows: each x (None passes through; its
        rows on axis ``dims``, or ``dims[i]`` for the i-th) extended by the
        site's halo (``HALOS[name]``) with its neighbours' rows, ``fn`` run
        as it is, and each output (a tensor, or a tuple of tensors and
        others) cropped back to the band in its own level's rows, on axis
        ``out_dims`` (default the first input's)."""
        dims = [dims] * len(xs) if isinstance(dims, int) else list(dims)
        live = [(x, d) for x, d in zip(xs, dims) if x is not None]
        rows = live[0][0].shape[live[0][1]]
        if any(x.shape[d] != rows for x, d in live):
            raise ValueError(f"spatial site {name!r}: inputs of {[x.shape[d] for x, d in live]} "
                             "rows")
        above, below = HALOS[name]
        if max(above, below) > rows:
            raise ValueError(
                f"spatial sharding: site {name!r} reads {max(above, below)} rows of each "
                f"neighbour band, which holds {rows} at this level: every band must hold at "
                "least the halo it exchanges at each level (H >= 16 x the bands for the "
                "bottleneck's 2 rows at H/8; 7 rows of the condition encoder's input)")
        up = above if self.index > 0 else 0
        down = below if self.index < self.count - 1 else 0
        sends, like = {}, {}
        if self.index > 0 and below:
            sends[self.index - 1] = [x.narrow(d, 0, below) for x, d in live]
        if self.index < self.count - 1 and above:
            sends[self.index + 1] = [x.narrow(d, rows - above, above) for x, d in live]
        if up:
            like[self.index - 1] = [x.narrow(d, 0, up) for x, d in live]
        if down:
            like[self.index + 1] = [x.narrow(d, 0, down) for x, d in live]
        got = self.link.swap(self.index, sends, like, live[0][0].device)
        ext, j = [], 0
        for x, d in zip(xs, dims):
            if x is None:
                ext.append(None)
                continue
            parts = ([got[self.index - 1][j]] if up else []) + [x] + (
                [got[self.index + 1][j]] if down else [])
            ext.append(_like(torch.cat(parts, d), x) if len(parts) > 1 else x)
            j += 1
        total = rows + up + down
        _WINDOW.ext = (up, down, total, name)
        try:
            out = fn(*ext)
        finally:
            _WINDOW.ext = None
        od = live[0][1] if out_dims is None else out_dims
        if isinstance(out, tuple):
            return tuple(_crop(o, od, total, up, down, name) for o in out)
        return _crop(out, od, total, up, down, name)


def _channels_last(x: torch.Tensor) -> bool:
    """Whether x is NCHW with channels-last strides (the trunk's tensors)."""
    return x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1 and x.stride(3) != 1


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y contiguous in x's memory format."""
    if _channels_last(x):
        return y.contiguous(memory_format=torch.channels_last)
    return y.contiguous()


def _own(y: torch.Tensor, d: int, total: int, up: int, down: int, name: str) -> torch.Tensor:
    """The view of the band's rows of ``y`` (rows on axis ``d``), a tensor
    at any level of a site whose input has ``total`` rows, ``up`` and
    ``down`` of them halo: the same share of y's rows."""
    n = y.shape[d]
    if (n * up) % total or (n * down) % total:
        raise ValueError(f"spatial site {name!r}: a tensor of {n} rows does not crop from "
                         f"{total} (halo {up}, {down})")
    a, b = n * up // total, n * down // total
    return y.narrow(d, a, n - a - b)


def _crop(y, d: int, total: int, up: int, down: int, name: str):
    """The band's rows of a site's output ``y`` on axis ``d``, its rows
    ``total`` at the input's level, ``up`` and ``down`` of them halo;
    anything but a tensor with that axis passes through."""
    if not torch.is_tensor(y) or y.dim() <= d or (up == 0 and down == 0):
        return y
    return _like(_own(y, d, total, up, down, name), y)


# the extension (up, down, total rows, site) of the site this thread's band
# is running, None between sites: what own_rows crops by
_WINDOW = threading.local()


def own_rows(x: torch.Tensor, axis: int, top: bool = False) -> torch.Tensor:
    """The rows of ``x`` (rows on ``axis``) that the band running on this
    thread owns, a view: inside a site's chain x spans the extended band, and
    its halo rows (the neighbours', and those the chain computes wrongly
    near the extended band's edge) are cut off; elsewhere x itself. With
    ``top``, x is the extended band's first row alone (the head's row-0
    correction reads it), the band's own only where nothing was added above
    (the image's top); else no rows. What a statistic of the whole image
    reads, band by band (``ops.quant``'s calibration maximum)."""
    ext = getattr(_WINDOW, "ext", None)
    if ext is None:
        return x
    up, down, total, name = ext
    if top:
        return x if up == 0 else x.narrow(axis, 0, 0)
    return _own(x, axis, total, up, down, name)


def site(band: Optional[Band], name: str, fn: Callable, *xs, dims=1, out_dims=None):
    """``fn(*xs)``, or on a band of a spatial split ``band.site(...)``: what
    the model calls at each exchange point."""
    if band is None or band.count == 1:
        return fn(*xs)
    return band.site(name, fn, *xs, dims=dims, out_dims=out_dims)


def make_link(spatial, bands: List[int]):
    """The exchange of a sampler call over ``spatial`` (a
    ``parallel.sharding.SpatialSharding``) for this process's ``bands``."""
    mesh = spatial.mesh
    if mesh.world > 1:
        return RankLink(mesh.group)
    return LocalLink(bands[0], len(bands))


def band_row_counts(name: str, rows: int, k: int) -> List[int]:
    """The row counts the chain of site ``name`` sees on the bands of an
    image split into k bands, ``rows`` rows at the site's level: the first
    band's, the inner ones' and the last's, each extended by the site's
    halo toward its neighbours only (the shapes its kernels get)."""
    above, below = HALOS[name]
    n = rows // k
    return sorted({n + below, n + above} | ({n + above + below} if k > 2 else set()))


def run_bands(spatial, fns: Sequence[Callable], args: Sequence) -> list:
    """``fns[j](band, *rows)`` for each of this process's bands j at once
    (one :func:`make_link` between them), ``rows`` each of ``args`` cut to
    the band's image rows: a tensor of 4 or more dims (NHWC, rows on axis
    1, at its own level: H, H/2 in s2d, H/mag) its share of them, any other
    argument whole. The image height is ``args[0]``'s. Results in band
    order."""
    local = spatial.local_bands()
    link = make_link(spatial, local)
    height = args[0].shape[1]
    rows = spatial.band_rows(height)

    def cut(a, r0, r1):
        if not torch.is_tensor(a) or a.dim() < 4:
            return a
        h = a.shape[1]
        return a.narrow(1, r0 * h // height, (r1 - r0) * h // height)

    def call(fn, i):
        return fn(Band(i, spatial.bands, link), *(cut(a, *rows[i]) for a in args))

    return link.run([lambda fn=fn, i=i: call(fn, i) for fn, i in zip(fns, local)])


def gather_bands(xs: List[torch.Tensor], spatial, device) -> torch.Tensor:
    """The whole image from this process's bands (NHWC, rows on axis 1) on
    ``device``, every rank's in rank order under a group (through the host
    under gloo, whose all-gather takes CPU tensors)."""
    x = torch.cat([b.to(device) for b in xs], dim=1)
    mesh = spatial.mesh
    if mesh.world == 1:
        return x
    via = device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    t = x.to(via).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=1).to(device)
