"""Reference-namespace shim: arpg/Kangaroo's `roo::` API by its own names
(``kangaroo_tpu/roo.py``).

A migration aid for users of the CUDA reference: every public kernel
entry point from include/kangaroo/kangaroo.h's headers is re-exported
here under its reference name, bound to the function of this package with
the module path and name the JAX package's shim binds.
`import kangaroo_tpu_torch.roo as roo; roo.GaussianBlur(img, sigma)` works
the way `roo::GaussianBlur(out, img, temp)` did, with the API differences
the framework makes everywhere:

- images/volumes are tensors `(H, W[, C])` / `(D, H, W)` passed by value
  and RETURNED, never written through out-params or pitched `Image<T>`
  views; intensity images are float32 in [0, 1];
- TSDF state is the `TsdfVolume` (`SdfReset` creates-or-clears it);
- the pose refinement functions return the reduced `LSS` system;
- there are no `<<<grid, block>>>` / stream arguments: a CUDA tensor runs
  on the card's current stream.

Names that were C++ template/overload families map to the richest
equivalent (e.g. `Census` takes `window='9x7'|'11x11'|'16x16'`;
`BilateralFilter` is the base overload — the `above_min` and cross-guide
overloads live next to it in `kangaroo_tpu_torch.ops.bilateral`).
Pixel-format conversions (`ConvertImage<To, From>`) are the functions in
`kangaroo_tpu_torch.ops.convert`.

As the JAX package's shim, this one binds the plain modules
(`SemiGlobalMatching` is `stereo.sgm.semi_global_matching`,
`CostVolMinimumSubpix` and `LeftRightCheck` are `stereo.costvolume`'s), so
no name here launches a CUDA kernel. The kernels of `csrc/` are reached
through the app entry points (`apps.stereo_sgm.sgm_pipeline`,
`apps.stereo`, `apps.kinectfusion`, `variational.rof.denoise`,
`variational.tgv.denoise`) and `stereo.dispatch`.
"""

from __future__ import annotations

# --- cu_blur.h / cu_bilateral.h / cu_median.h / cu_convolution.h ---
from .ops.blur import blur as Blur, gaussian_blur as GaussianBlur
from .ops.bilateral import bilateral as BilateralFilter
from .ops.median import (
    median_filter_3x3 as MedianFilter3x3,
    median_filter_5x5 as MedianFilter5x5,
    median_filter_reject_negative_5x5 as MedianFilterRejectNegative5x5,
    median_filter_reject_negative_7x7 as MedianFilterRejectNegative7x7,
    median_filter_reject_negative_9x9 as MedianFilterRejectNegative9x9,
)
from .ops.convolution import convolve as Convolution

# --- cu_integral_image.h ---
from .ops.integral_image import (
    prefix_sum_rows as PrefixSumRows,
    transpose as Transpose,
    box_filter as BoxFilter,
    box_filter_integral_image as BoxFilterIntegralImage,
    mean_variance as ComputeMeanVarience,  # reference's spelling
)

# --- cu_operations.h ---
from .ops.elementwise import (
    fill as Fill,
    scale_bias as ElementwiseScaleBias,
    add as ElementwiseAdd,
    multiply as ElementwiseMultiply,
    divide as ElementwiseDivision,
    square as ElementwiseSquare,
    multiply_add as ElementwiseMultiplyAdd,
    image_l1 as ImageL1,
)

# --- cu_lookup_warp.h / cu_anaglyph.h / cu_painting.h / cu_remap.h ---
from .ops.warp import (
    create_matlab_lookup_table as CreateMatlabLookupTable,
    warp as Warp,
)
from .ops.viz import (
    make_anaglyph as MakeAnaglyth,  # reference's spelling
    paint_circle as PaintCircle,
    remap_heat as Remap,
    disparity_cross_section as DisparityImageCrossSection,
)

# --- cu_resample.h / reduce.h ---
from .ops.resample import (
    resample as Resample,
    box_half as BoxHalf,
    box_half_ignore_invalid as BoxHalfIgnoreInvalid,
)
from .containers.pyramid import (
    box_reduce as BoxReduce,
    box_reduce_ignore_invalid as BoxReduceIgnoreInvalid,
    blur_reduce as BlurReduce,
)

# --- cu_integral_image.h (statistics + guided filter) ---
from .ops.integral_image import (
    covariance as ComputeCovariance,
    guided_filter as GuidedFilter,
)

# --- cu_segment_test.h ---
from .ops.features import (
    segment_test as SegmentTest,
    harris_score as HarrisScore,
    non_maximal_suppression as NonMaximalSuppression,
)

# --- cu_census.h ---
from .stereo.census import (
    census as Census,
    census_stereo as CensusStereo,
    census_cost_volume as CensusStereoVolume,
)

# --- cu_dense_stereo.h ---
from .stereo.costvolume import (
    cost_vol_minimum as CostVolMinimum,
    cost_vol_minimum_subpix as CostVolMinimumSubpix,
    cost_vol_minimum_square_penalty_subpix as CostVolMinimumSquarePenaltySubpix,
    exponential_edge_weight as ExponentialEdgeWeight,
    left_right_check as LeftRightCheck,
    filter_disp_grad as FilterDispGrad,
    cost_volume_zero as CostVolumeZero,
    cost_volume_from_stereo as CostVolumeFromStereo,
    cost_volume_add as CostVolumeAdd,
    cost_volume_from_stereo_truncated_abs_and_grad
        as CostVolumeFromStereoTruncatedAbsAndGrad,
)
from .stereo.dense_stereo import (
    dense_stereo as DenseStereo,
    dense_stereo_subpixel_refine as DenseStereoSubpixelRefine,
)
# CostVolumeCrossSection is a dedicated adapter below (the reference takes
# (dScore, dCostVol, y) with CostVolElem normalisation, cu_dense_stereo.cu:783
# — NOT the disparity-marking DisparityImageCrossSection signature).

# --- cu_semi_global_matching.h ---
from .stereo.sgm import semi_global_matching as SemiGlobalMatching

# --- cu_depth_tools.h / cu_normals.h ---
from .geometry.depth import (
    disp_to_depth as Disp2Depth,
    depth_from_disparity_vbo as DisparityImageToVbo,
    filter_bad_kinect_data as FilterBadKinectData,
    depth_to_vbo as DepthToVbo,
    colour_vbo as ColourVbo,
    normals_from_vbo as NormalsFromVbo,
    texture_depth as TextureDepth,
)

# --- cu_sdffusion.h / cu_raycast.h ---
from .fusion.sdf import (
    sdf_fuse as SdfFuse,
    sdf_reset as SdfReset,
    sdf_sphere as SdfSphere,
    sdf_distance as SdfDistance,
)
from .fusion.raycast import (
    raycast_sdf as RaycastSdf,
    raycast_box as RaycastBox,
    raycast_sphere as RaycastSphere,
    raycast_plane as RaycastPlane,
)

# --- cu_model_refinement.h / cu_plane_fit.h / cu_manhattan.h ---
from .solvers.photometric import (
    pose_refinement_from_points as PoseRefinementFromVbo,
    pose_refinement_from_disparity as PoseRefinementFromDisparity,
    pose_refinement_from_disparity_esm as PoseRefinementFromDisparityESM,
    pose_refinement_from_depth_esm as PoseRefinementFromDepthESM,
)
from .solvers.icp import icp_point_plane as PoseRefinementProjectiveIcpPointPlane
from .solvers.calibration import (
    calibration_rgbd_from_depth_esm as CalibrationRgbdFromDepthESM,
    kinect_calibration as KinectCalibration,
)
from .solvers.plane_fit import plane_fit_gn as PlaneFitGN
from .solvers.manhattan import manhattan_line_cost as ManhattanLineCost

# --- cu_heightmap.h / cu_index_buffer.h ---
from .geometry.heightmap import (
    init_heightmap as InitHeightMap,
    update_heightmap as UpdateHeightMap,
    vbo_from_heightmap as VboFromHeightMap,
    vbo_world_from_heightmap as VboWorldFromHeightMap,
    colour_heightmap as ColourHeightMap,
    generate_world_vbo_and_image as GenerateWorldVboAndImageFromHeightmap,
    triangle_strip_index_buffer as GenerateTriangleStripIndexBuffer,
)

# --- cu_rof_denoising.h / cu_tgv.h / cu_deconvolution.h ---
from .variational.ops import grad_forward as GradU, divergence as Divergence
from .variational.rof import (
    tvl1_dual_ascent_p as TVL1GradU_DualAscentP,
    huber_dual_ascent_p as HuberGradU_DualAscentP,
    weighted_huber_dual_ascent_p as WeightedHuberGradU_DualAscentP,
    l2_primal_descent as L2_u_minus_g_PrimalDescent,
    weighted_l2_primal_descent as WeightedL2_u_minus_g_PrimalDescent,
)
from .variational.tgv import iteration as TGV_L1_DenoisingIteration
from .variational.deconvolution import (
    dual_q_ascent as DeconvolutionDual_qAscent,
    primal_u_descent as Deconvolution_uDescent,
)

# --- overload families / demo entry points that need a small adapter ---


def ConvertImage(img, to: str, **kw):
    """ConvertPixel<To, Ti> dispatcher (cu_convert.cu:14-44). ``to`` selects
    the target family: 'gray', 'rgb', 'rgba', 'float', 'uint8'. The source
    format is inferred from the array rank/dtype, mirroring how the C++
    template pair <To, Ti> picked the conversion."""
    from .ops import convert as _cv

    gray = img.ndim == 2
    if to == "gray":
        return img if gray else _cv.rgb_to_gray(img)
    if to == "rgb":
        if gray:
            return _cv.gray_to_rgb(img)
        return _cv.rgba_to_rgb(img) if img.shape[-1] == 4 else img
    if to == "rgba":
        if gray:
            return _cv.gray_to_rgba(img, **kw)
        return img if img.shape[-1] == 4 else _cv.rgb_to_rgba(img, **kw)
    if to == "float":
        return _cv.to_float(img, **kw)
    if to == "uint8":
        return _cv.to_uint8(img, **kw)
    raise ValueError(f"unknown target format {to!r}")


def CostVolumeCrossSection(vol, y: int):
    """Normalised cost-volume slice at row ``y`` (KernCostVolumeCrossSection,
    cu_dense_stereo.cu:767-789): score = (sum / n) / 255 per (d, x) element
    of a CostVolElem volume. ``vol`` is the (n, s) accumulator pair from
    ``CostVolumeZero``/``CostVolumeAdd``, or a plain float (D, H, W) volume
    (then only the /255 viz scaling applies). Unvisited elements (n == 0)
    render as NaN (InvalidValue<float>). Returns the (D, W) score image."""
    import torch

    if isinstance(vol, (tuple, list)):
        n, s = vol
        sl_n = n[:, y, :].to(torch.float32)
        sl_s = s[:, y, :].to(torch.float32)
        return torch.where(sl_n > 0, (sl_s / sl_n) / 255.0, float("nan"))
    return vol[:, y, :].to(torch.float32) / 255.0


def DenseStereoTest(left, right, max_disp: int, rad: int = 3):
    """The reference's shared-memory SAD WTA demo kernel (DenseStereoTest,
    cu_dense_stereo.cu:451-506) — plain SAD patch-match WTA here."""
    return DenseStereo(left, right, max_disp, rad=rad, kind="sad")


def DenseStereoSubpix(left, right, max_disp: int, rad: int = 1,
                      kind: str = "sand", accept_thresh=0.0):
    """Integer WTA + parabola refinement in one call. The reference declares
    this (cu_dense_stereo.h) but its kernel body is commented out
    (cu_dense_stereo.cu:407-446); this composes the two live ops the way the
    gutted kernel intended."""
    d = DenseStereo(left, right, max_disp, rad=rad, kind=kind,
                    accept_thresh=accept_thresh)
    return DenseStereoSubpixelRefine(d.float(), left, right, rad=rad, kind=kind)


def SumSpeedTest(J, y, w=None, valid=None):
    """LeastSquaresSystem reduction benchmark entry (SumSpeedTest,
    cu_model_refinement.cu:708-733; timed by CudaSumSpeed.cpp:26-35).
    Reduces per-pixel (J, y) into the 6-dof normal equations (see
    examples/sum_speed_demo.py for the timed harness)."""
    import torch

    from .solvers.lss import reduce_system

    if w is None:
        w = torch.ones(y.shape, dtype=torch.float32, device=y.device)
    if valid is None:
        valid = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    return reduce_system(J, y, w, valid)


__all__ = [n for n in dir() if n[0].isupper()]
