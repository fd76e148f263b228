# Copy of tpuh264/core/params.py, so that the port imports nothing of tpuh264,
# plus `param_sets` (the SPS + PPS NAL units every IDR access unit opens with).
"""SPS / PPS syntax (H.264 7.3.2.1, 7.3.2.2).

Scope: progressive 4:2:0 8-bit streams as produced by this encoder --
baseline-profile CAVLC first (the reference encoder's operating point:
OpenH264 CAMERA_VIDEO_REAL_TIME at reference/openh264_wrapper.cpp:206-227
emits constrained-baseline), with fields needed for later main/high
(CABAC, 8x8 transform) already modeled.
"""

from __future__ import annotations

import dataclasses

from . import nal
from .bitstream import BitReader, BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100


def level_for(width: int, height: int, fps: int = 30) -> int:
    """Pick level_idc by resolution, mirroring the reference's WebCodecs
    ladder (reference/scripts/app.js:617-626): L3.0 <=480p,
    L3.1 <=720p, L4.1 <=1080p, L5.1 above."""
    pixels = width * height
    if pixels <= 854 * 480:
        return 30
    if pixels <= 1280 * 720:
        return 31
    if pixels <= 1920 * 1088:
        return 41
    return 51


@dataclasses.dataclass
class SPS:
    profile_idc: int = PROFILE_BASELINE
    constraint_set_flags: int = 0  # bits 7..0 = constraint_set0..7 as u(8)
    level_idc: int = 30
    seq_parameter_set_id: int = 0
    log2_max_frame_num_minus4: int = 4
    log2_max_pic_order_cnt_lsb_minus4: int = 4
    pic_order_cnt_type: int = 2  # POC from decoding order: no B-frames
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs_minus1: int = 0
    pic_height_in_map_units_minus1: int = 0
    frame_mbs_only_flag: int = 1
    direct_8x8_inference_flag: int = 1
    # frame cropping, in luma samples, for non-multiple-of-16 sizes
    crop_right: int = 0
    crop_bottom: int = 0

    @classmethod
    def for_size(
        cls, width: int, height: int, profile_idc: int = PROFILE_BASELINE, **kw
    ) -> "SPS":
        mb_w = (width + 15) // 16
        mb_h = (height + 15) // 16
        constraint = 0xE0 if profile_idc == PROFILE_BASELINE else 0
        return cls(
            profile_idc=profile_idc,
            constraint_set_flags=constraint,
            level_idc=level_for(width, height),
            pic_width_in_mbs_minus1=mb_w - 1,
            pic_height_in_map_units_minus1=mb_h - 1,
            crop_right=mb_w * 16 - width,
            crop_bottom=mb_h * 16 - height,
            **kw,
        )

    @property
    def width(self) -> int:
        return (self.pic_width_in_mbs_minus1 + 1) * 16 - self.crop_right

    @property
    def height(self) -> int:
        return (self.pic_height_in_map_units_minus1 + 1) * 16 - self.crop_bottom

    @property
    def mb_width(self) -> int:
        return self.pic_width_in_mbs_minus1 + 1

    @property
    def mb_height(self) -> int:
        return self.pic_height_in_map_units_minus1 + 1

    def write(self, w: BitWriter) -> None:
        w.u(8, self.profile_idc)
        w.u(8, self.constraint_set_flags)
        w.u(8, self.level_idc)
        w.ue(self.seq_parameter_set_id)
        if self.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            w.ue(1)  # chroma_format_idc = 4:2:0
            w.ue(0)  # bit_depth_luma_minus8
            w.ue(0)  # bit_depth_chroma_minus8
            w.u(1, 0)  # qpprime_y_zero_transform_bypass_flag
            w.u(1, 0)  # seq_scaling_matrix_present_flag
        w.ue(self.log2_max_frame_num_minus4)
        w.ue(self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            w.ue(self.log2_max_pic_order_cnt_lsb_minus4)
        elif self.pic_order_cnt_type == 1:
            raise NotImplementedError("pic_order_cnt_type 1")
        w.ue(self.max_num_ref_frames)
        w.u(1, self.gaps_in_frame_num_value_allowed_flag)
        w.ue(self.pic_width_in_mbs_minus1)
        w.ue(self.pic_height_in_map_units_minus1)
        w.u(1, self.frame_mbs_only_flag)
        if not self.frame_mbs_only_flag:
            w.u(1, 0)  # mb_adaptive_frame_field_flag
        w.u(1, self.direct_8x8_inference_flag)
        cropping = int(bool(self.crop_right or self.crop_bottom))
        w.u(1, cropping)
        if cropping:
            # 4:2:0 frame: units of 2 luma samples horizontally/vertically
            w.ue(0)
            w.ue(self.crop_right // 2)
            w.ue(0)
            w.ue(self.crop_bottom // 2)
        w.u(1, 0)  # vui_parameters_present_flag
        w.rbsp_trailing_bits()

    @classmethod
    def parse(cls, r: BitReader) -> "SPS":
        sps = cls()
        sps.profile_idc = r.u(8)
        sps.constraint_set_flags = r.u(8)
        sps.level_idc = r.u(8)
        sps.seq_parameter_set_id = r.ue()
        if sps.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            chroma_format_idc = r.ue()
            if chroma_format_idc != 1:
                raise NotImplementedError("only 4:2:0 supported")
            if r.ue() or r.ue():
                raise NotImplementedError("only 8-bit supported")
            r.u(1)
            if r.u(1):
                raise NotImplementedError("scaling matrices")
        sps.log2_max_frame_num_minus4 = r.ue()
        sps.pic_order_cnt_type = r.ue()
        if sps.pic_order_cnt_type == 0:
            sps.log2_max_pic_order_cnt_lsb_minus4 = r.ue()
        elif sps.pic_order_cnt_type == 1:
            raise NotImplementedError("pic_order_cnt_type 1")
        sps.max_num_ref_frames = r.ue()
        sps.gaps_in_frame_num_value_allowed_flag = r.u(1)
        sps.pic_width_in_mbs_minus1 = r.ue()
        sps.pic_height_in_map_units_minus1 = r.ue()
        sps.frame_mbs_only_flag = r.u(1)
        if not sps.frame_mbs_only_flag:
            raise NotImplementedError("interlace")
        sps.direct_8x8_inference_flag = r.u(1)
        if r.u(1):  # frame_cropping_flag
            left, right, top, bottom = r.ue(), r.ue(), r.ue(), r.ue()
            if left or top:
                raise NotImplementedError("left/top cropping")
            sps.crop_right = right * 2
            sps.crop_bottom = bottom * 2
        r.u(1)  # vui_parameters_present_flag (VUI ignored if absent)
        return sps


@dataclasses.dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0  # 0 = CAVLC, 1 = CABAC
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp_minus26: int = 0
    pic_init_qs_minus26: int = 0
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 1
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    transform_8x8_mode_flag: int = 0  # High profile: 8x8 transform

    def write(self, w: BitWriter) -> None:
        w.ue(self.pic_parameter_set_id)
        w.ue(self.seq_parameter_set_id)
        w.u(1, self.entropy_coding_mode_flag)
        w.u(1, self.bottom_field_pic_order_in_frame_present_flag)
        w.ue(0)  # num_slice_groups_minus1
        w.ue(self.num_ref_idx_l0_default_active_minus1)
        w.ue(self.num_ref_idx_l1_default_active_minus1)
        w.u(1, self.weighted_pred_flag)
        w.u(2, self.weighted_bipred_idc)
        w.se(self.pic_init_qp_minus26)
        w.se(self.pic_init_qs_minus26)
        w.se(self.chroma_qp_index_offset)
        w.u(1, self.deblocking_filter_control_present_flag)
        w.u(1, self.constrained_intra_pred_flag)
        w.u(1, self.redundant_pic_cnt_present_flag)
        if self.transform_8x8_mode_flag:  # PPS extension (7.3.2.2)
            w.u(1, 1)  # transform_8x8_mode_flag
            w.u(1, 0)  # pic_scaling_matrix_present_flag
            w.se(self.chroma_qp_index_offset)  # second_chroma_qp_index_offset
        w.rbsp_trailing_bits()

    @classmethod
    def parse(cls, r: BitReader) -> "PPS":
        pps = cls()
        pps.pic_parameter_set_id = r.ue()
        pps.seq_parameter_set_id = r.ue()
        pps.entropy_coding_mode_flag = r.u(1)
        pps.bottom_field_pic_order_in_frame_present_flag = r.u(1)
        if r.ue() != 0:
            raise NotImplementedError("slice groups (FMO)")
        pps.num_ref_idx_l0_default_active_minus1 = r.ue()
        pps.num_ref_idx_l1_default_active_minus1 = r.ue()
        pps.weighted_pred_flag = r.u(1)
        pps.weighted_bipred_idc = r.u(2)
        pps.pic_init_qp_minus26 = r.se()
        pps.pic_init_qs_minus26 = r.se()
        pps.chroma_qp_index_offset = r.se()
        pps.deblocking_filter_control_present_flag = r.u(1)
        pps.constrained_intra_pred_flag = r.u(1)
        pps.redundant_pic_cnt_present_flag = r.u(1)
        if r.more_rbsp_data():  # PPS extension (7.3.2.2): High profile
            pps.transform_8x8_mode_flag = r.u(1)
            if r.u(1):
                raise NotImplementedError("pic_scaling_matrix")
            r.se()  # second_chroma_qp_index_offset
        return pps


def param_sets(sps: SPS, pps: PPS) -> bytes:
    """SPS + PPS NAL units."""
    w = BitWriter()
    sps.write(w)
    out = nal.wrap_nal(nal.NAL_SPS, w.get_bytes())
    w = BitWriter()
    pps.write(w)
    return out + nal.wrap_nal(nal.NAL_PPS, w.get_bytes())
