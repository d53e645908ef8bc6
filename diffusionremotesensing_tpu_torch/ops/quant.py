"""W8A8 static-calibration int8 inference, opt-in (port of
``diffusionremotesensing_tpu/ops/quant.py``).

Activations take a static per-site scale from a calibration pass, weights a
per-output-channel scale computed at each call; both are symmetric int8
(scale ``amax / 127``, values rounded half to even and clipped to +-127),
the product accumulates in int32 and is dequantized in float32 as
``acc * (sx * sw)``, then cast to the site's dtype. Not an fp-equivalent
path: default off everywhere, quality-gated end to end.

The conv sites and their names:

* module sites, the models' ``QConv2d`` / ``QConvTranspose2d``
  (``models.blocks.TorchConv`` / ``ConvTranspose2x``), named by their module
  path in the model (``conv_blocks.1.conv1.0``, ``ups.0.transform``);
* the s2d path's own convolutions (``ResidualAttentionUNet._qconv``),
  named by the reference's labels (``s2d.conv0``, ``s2d.head_up4``).

Each site asks the model's :class:`QuantSites` for its scale: during a
calibration pass (:func:`calibrate`) the site records max|x| and runs the
exact convolution; with a quant map attached (:func:`attach`) a site that
has a scale runs :func:`conv_int8`; otherwise the exact convolution, so a
model without a quant map computes bitwise what it did before. The
convolutions inside the hand-written kernels (tap_block, tap_stem_block,
att_head_block, dec_block, the gates, packed_head) stay in the kernel's
dtype: the reference's Pallas kernels have no int8 path either.

The int8 product: the quantized activations are unfolded (im2col, the
input dilated first for a ConvTranspose) and multiplied by the quantized
weights as one (M, K) x (K, N) integer product, :func:`int8_matmul`:
``torch._int_mm``, cuBLASLt's int8 GEMM on the card and oneDNN's on the
CPU, K and N padded with zeros to multiples of 8 and M to more than 16 as
the card's requires. Its plain version, :func:`int8_matmul_plain`, is an
int32 product on the CPU. Integer arithmetic is exact, so the two agree
bitwise on the int32 accumulators. A float32 product would not be exact:
K * 127^2 passes 2^24 at K = 1041.

The probes' noise comes from an explicit ``torch.Generator`` where the
reference folds keys, so a calibration here draws other noise than the
reference's; :func:`calibrate` on the same probes gives the same scales.

Under a spatial split (``calibrate(..., spatial=...)``, the reference's
calibration on ``spatial_sharding`` probes, whose maxima XLA reduces over
the mesh) each probe runs band by band (``parallel.halo.run_bands``), every
band on its own thread in one process: a site records the max over the
band's own rows of its input (``parallel.halo.own_rows``), merged under a
lock, and the ranks of a process group merge theirs by one
``all_reduce(MAX)``. So every row of the image counts once and no halo row
counts: the scales are the whole image's, up to the float rounding of the
convolutions before each site. With a quant map attached, a band's sites
read the same global scales.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from diffusionremotesensing_tpu_torch.ops.resize import resize_bicubic_keys
from diffusionremotesensing_tpu_torch.parallel.halo import own_rows, run_bands

# sites never quantized by default (substring match on the site name): the
# composed output head and its boundary fixes ("s2d.head*"), the plain
# path's output conv, and the one-channel attention projections psi (the
# reference's "psi/" path part is ".psi." in a module path here)
DEFAULT_EXCLUDE = ("head", "_psi", ".psi.", "output")

_EPS = 1e-12


def abs_max(x: torch.Tensor) -> torch.Tensor:
    """Scalar float32 max|x| (the calibration statistic)."""
    return x.float().abs().max()


class QuantSites:
    """The W8A8 state a model shares with its conv sites (the port of the
    reference's ``"quant"`` variable collection and ``module_amax``):
    ``scales`` maps site names to calibrated activation amaxes (None: no
    quant map, every site exact); ``calib`` collects each site's max|x|
    during a calibration pass (None outside one). A model's replicas on
    other devices (``DiffusionProcess.replica``) share this object, so a
    quant map attached to the model reaches them too: each device reads its
    own copy of the scales, made on its first read after the map changed.
    The bands of a spatial split call :meth:`amax` from several threads at
    once: the merge of a maximum and the copy to a device hold a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.scales = None
        self.calib: Optional[Dict[str, torch.Tensor]] = None

    def __getstate__(self):  # a model's deep copy copies this; a lock does not copy
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    @property
    def scales(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._scales

    @scales.setter
    def scales(self, qmap: Optional[Dict[str, torch.Tensor]]):
        self._scales = qmap
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def amax(self, name: str, x: torch.Tensor, rows: int,
             top: bool = False) -> Optional[torch.Tensor]:
        """During calibration record max|x| under ``name`` (merged by
        maximum; on a band of a spatial split over the band's own rows of
        x's axis ``rows``, ``parallel.halo.own_rows``, 0 where it owns none)
        and return None, so the caller runs the exact conv; with a quant
        map, the site's scale on ``x``'s device (None if it has none); else
        None."""
        if self.calib is not None:
            own = own_rows(x, rows, top)
            a = abs_max(own) if own.numel() else torch.zeros((), device=x.device)
            with self._lock:
                prev = self.calib.get(name)
                self.calib[name] = a if prev is None else torch.maximum(prev, a.to(prev.device))
            return None
        if self._scales is None:
            return None
        on = self._on_device.get(x.device)
        if on is None:
            with self._lock:
                on = self._on_device.get(x.device)
                if on is None:
                    on = {k: v.to(x.device) for k, v in self._scales.items()}
                    self._on_device[x.device] = on
        return on.get(name)


def weight_qparams(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of an OIHW kernel:
    (wq int8, sw float32 (O,))."""
    wf = w.float()
    sw = torch.clamp(wf.abs().amax(dim=tuple(range(1, wf.dim()))), min=_EPS) / 127.0
    wq = torch.clamp(torch.round(wf / sw.reshape((-1,) + (1,) * (wf.dim() - 1))), -127, 127)
    return wq.to(torch.int8), sw


def quantize_act(x: torch.Tensor, amax: torch.Tensor):
    """Activation quantization with a static scale: (xq int8, sx float32)."""
    sx = torch.clamp(amax.float(), min=_EPS) / 127.0
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times (N, K) int8 transposed -> (M, N) int32, exact: an
    int32 product on the CPU (the result goes back to ``a``'s device)."""
    out = a.cpu().to(torch.int32) @ b.cpu().to(torch.int32).t()
    return out.to(a.device)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times (N, K) int8 transposed -> (M, N) int32 through
    ``torch._int_mm``, K and N padded with zeros to multiples of 8 and M to
    at least 17 (what the card's requires)."""
    m, k = a.shape
    n = b.shape[0]
    kp, np_, mp = -(-k // 8) * 8, -(-n // 8) * 8, max(m, 17)
    a = F.pad(a, (0, kp - k, 0, mp - m))
    b = F.pad(b, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), b.contiguous().t())[:m, :n]


def _pads(padding):
    """An int, (ph, pw) or ((top, bottom), (left, right)) -> the latter."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    ph, pw = padding
    return (ph, ph) if isinstance(ph, int) else tuple(ph), (pw, pw) if isinstance(pw, int) else tuple(pw)


def im2col_int8(xq: torch.Tensor, kh: int, kw: int, stride=1, padding=0, lhs_dilation=1):
    """NHWC int8 -> ((B * Ho * Wo, kh * kw * C) int8, (B, Ho, Wo)): each row
    one output pixel's window, taps (u, v) major and channels minor (the
    order of an OHWI kernel's rows). ``lhs_dilation`` d puts d - 1 zeros
    between input pixels first (a transposed convolution's input)."""
    b, h, w, c = xq.shape
    if lhs_dilation > 1:
        d = lhs_dilation
        xd = xq.new_zeros((b, (h - 1) * d + 1, (w - 1) * d + 1, c))
        xd[:, ::d, ::d] = xq
        xq = xd
    (t, bo), (le, r) = _pads(padding)
    xp = F.pad(xq, (0, 0, le, r, t, bo))
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    ho = (xp.shape[1] - kh) // sh + 1
    wo = (xp.shape[2] - kw) // sw + 1
    cols = torch.stack([xp[:, u:u + (ho - 1) * sh + 1:sh, v:v + (wo - 1) * sw + 1:sw]
                        for u in range(kh) for v in range(kw)], dim=3)
    return cols.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def conv_int8_acc(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0, lhs_dilation=1,
                  matmul=int8_matmul) -> torch.Tensor:
    """The int32 accumulators of an int8 convolution: NHWC int8 input, OIHW
    int8 kernel -> NHWC int32, through ``matmul`` (:func:`int8_matmul`, or
    :func:`int8_matmul_plain` for the exact plain version)."""
    o, _, kh, kw = wq.shape
    a, (b, ho, wo) = im2col_int8(xq, kh, kw, stride, padding, lhs_dilation)
    acc = matmul(a, wq.permute(0, 2, 3, 1).reshape(o, -1))
    return acc.reshape(b, ho, wo, o)


def conv_int8(x: torch.Tensor, w: torch.Tensor, amax: torch.Tensor, stride=1, padding=0,
              lhs_dilation=1, groups: int = 1) -> torch.Tensor:
    """The W8A8 sandwich for one conv site: NHWC ``x``, OIHW ``w``, the
    site's calibrated ``amax`` -> float32 NHWC (callers cast, and add the
    bias after). ``padding`` is an int or ((top, bottom), (left, right));
    ``lhs_dilation`` 2 with the flipped kernel is a ConvTranspose2x. A
    grouped convolution stays exact, as in the reference."""
    if groups != 1:
        (t, bo), (le, r) = _pads(padding)
        y = F.conv2d(F.pad(x.float(), (0, 0, le, r, t, bo)).permute(0, 3, 1, 2), w.float(),
                     stride=stride, groups=groups)
        return y.permute(0, 2, 3, 1)
    xq, sx = quantize_act(x, amax)
    wq, sw = weight_qparams(w)
    acc = conv_int8_acc(xq, wq, stride, padding, lhs_dilation)
    return acc.float() * (sx * sw)


# --------------------------------------------------------------- calibration


@torch.no_grad()
def calibrate(model, probes: Sequence[tuple], spatial=None,
              **forward_kwargs) -> Dict[str, torch.Tensor]:
    """Each conv site's activation max|x| over ``probes`` (tuples of the
    model's positional arguments, e.g. (x, t, cond)), merged by maximum
    across them: {site name: float32 scalar}. Every site runs its exact
    convolution meanwhile. Build the model with the flags it will serve
    with (s2d, tap44, dtype) first: the sites a forward reaches are those of
    its execution path.

    ``spatial`` (``parallel.sharding.spatial_sharding(mesh)``): each probe's
    height split into bands over the mesh (module docstring), the model
    copied onto each band's device; under a process group every rank
    passes the same whole probes and gets the same scales."""
    sites = model.quant_sites
    sites.calib = {}
    try:
        if spatial is None:
            for probe in probes:
                model(*probe, **forward_kwargs)
        else:
            nets = _band_nets(model, spatial)
            for probe in probes:
                run_bands(spatial, [lambda band, *a, net=net: net(
                    *(v.to(net.conv0.weight.device) if torch.is_tensor(v) else v for v in a),
                    band=band, **forward_kwargs) for net in nets], probe)
        return _max_over_ranks(dict(sites.calib), spatial)
    finally:
        sites.calib = None


def _band_nets(model, spatial) -> list:
    """The model on each of this process's band devices: itself for the
    first band on its device, else a copy that shares its ``QuantSites``
    (a band's forward may swap its module's parameters, so no two bands
    share one module)."""
    nets, home = [], model.conv0.weight.device
    for j, d in enumerate(spatial.mesh.devices):
        d = torch.device(d)
        if d == home and j == 0:
            nets.append(model)
        else:
            sites = model.quant_sites
            nets.append(copy.deepcopy(model, {id(sites): sites}).to(d))
    return nets


def _max_over_ranks(qmap: Dict[str, torch.Tensor], spatial) -> Dict[str, torch.Tensor]:
    """``qmap`` with every site's value the maximum over the ranks of the
    spatial split's process group: one all_reduce(MAX) of the values in
    the sites' sorted order, on the card under NCCL, through the host
    under gloo (``parallel.sharding.BACKENDS``)."""
    if spatial is None or spatial.mesh.world == 1:
        return qmap
    group, names = spatial.mesh.group, sorted(qmap)
    dev = spatial.mesh.device
    via = dev if dist.get_backend(group) == "nccl" else torch.device("cpu")
    vals = torch.stack([qmap[k].float().to(via) for k in names])
    dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=group)
    return {k: v.to(qmap[k].device) for k, v in zip(names, vals)}


def filter_scales(qmap: Dict[str, torch.Tensor], exclude=DEFAULT_EXCLUDE,
                  margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """The quantization policy: drop sites whose name contains an
    ``exclude`` substring, scale the kept amaxes by ``margin`` (> 1 leaves
    clipping headroom beyond the probes)."""
    return {k: v.float() * margin for k, v in qmap.items() if not any(e in k for e in exclude)}


def attach(model, qmap: Optional[Dict[str, torch.Tensor]]):
    """Give ``model`` the (filtered) quant map: every site with a scale runs
    int8 from now on; None detaches it. Returns the model."""
    model.quant_sites.scales = None if qmap is None else dict(qmap)
    return model


def _merge_max(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge two quant maps by maximum, keeping sites present in one only."""
    out = dict(a)
    for k, v in b.items():
        out[k] = torch.maximum(a[k].float(), v.float()) if k in a else v
    return out


def quantize_for_sampling(model, alpha_hat: torch.Tensor, x0_proxy: torch.Tensor, cond,
                          generator: Optional[torch.Generator], ts=None,
                          exclude=DEFAULT_EXCLUDE, margin: float = 1.05,
                          cond_mask: Optional[torch.Tensor] = None,
                          spatial=None) -> Dict[str, torch.Tensor]:
    """The W8A8 quant map of a sampling workload: probes spanning the
    denoising trajectory (:func:`sampling_probes`), every site calibrated,
    the default policy applied; :func:`attach` it to the model that samples.
    ``cond_mask`` (classifier-free guidance): a half-ones, half-zeros mask,
    so that the scales see both guidance regimes. ``spatial``: each probe
    split into bands, as :func:`calibrate` (under a process group the
    generator's state the same on every rank, so the probes are).

    As in the reference, a model with a ``tap44`` level is calibrated on the
    dense-s2d branch as well (tap44 off over the same probes, merged by
    maximum), so that every site holds a scale whichever branch a batch
    takes."""
    probes = [p if cond is None else (p + (cond,) if cond_mask is None else p + (cond, cond_mask))
              for p in sampling_probes(x0_proxy, alpha_hat, generator, ts)]
    qmap = calibrate(model, probes, spatial)
    level = getattr(model, "tap44", False)
    if level:
        model.tap44 = False
        try:
            qmap = _merge_max(qmap, calibrate(model, probes, spatial))
        finally:
            model.tap44 = level
    return filter_scales(qmap, exclude=exclude, margin=margin)


def quantize_superres_tile(model, alpha_hat: torch.Tensor, lr_img, patch_size: int,
                           magnification: int, generator: Optional[torch.Generator],
                           n_patches: int = 4, **kw) -> Dict[str, torch.Tensor]:
    """The W8A8 quant map for tiled super-resolution of ``lr_img`` (H, W, C):
    calibrated on its corner patches, whose bicubic x``magnification``
    upsample (``jax.image.resize``'s, :func:`ops.resize.resize_bicubic_keys`)
    is the x0 proxy. Attach it to the process's net; the AggregationSampler
    runs unchanged."""
    dev = model.conv0.weight.device
    lr = torch.as_tensor(np.asarray(lr_img, np.float32)).to(dev)
    h, w = lr.shape[0], lr.shape[1]
    ys = sorted({0, max(0, h - patch_size)})
    xs = sorted({0, max(0, w - patch_size)})
    crops = [lr[y:y + patch_size, x:x + patch_size] for y in ys for x in xs]
    cond = torch.stack(crops[:n_patches])
    hr = patch_size * magnification
    x0 = resize_bicubic_keys(cond, hr, hr)
    return quantize_for_sampling(model, alpha_hat, x0, cond, generator, **kw)


def sampling_probes(x0_proxy: torch.Tensor, alpha_hat: torch.Tensor,
                    generator: Optional[torch.Generator], ts=None):
    """Calibration probes (x_t, t) spanning the trajectory without running a
    chain: x_t = sqrt(a_hat_t) x0 + sqrt(1 - a_hat_t) eps, eps drawn from
    ``generator`` on x0's device, in float32. Default ``ts``: six timesteps
    over [1, T), from the noise-dominated to the image-dominated regime."""
    if ts is None:
        T = int(alpha_hat.shape[0])
        ts = sorted({max(1, min(T - 1, int(round(f * (T - 1)))))
                     for f in (0.002, 0.1, 0.3, 0.5, 0.75, 0.95)})
    x0 = x0_proxy.float()
    probes = []
    for t in ts:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device)
        a = alpha_hat[t].float().to(x0.device)
        x_t = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
        probes.append((x_t, torch.full((x0.shape[0],), t, dtype=torch.int64, device=x0.device)))
    return probes
