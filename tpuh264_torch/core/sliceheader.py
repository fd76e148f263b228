# Copy of tpuh264/core/sliceheader.py, so that the port imports nothing of tpuh264.
"""Slice header syntax (H.264 7.3.3) for progressive I/P slices.

Each MB row can be its own slice (`slice_mode='rows'` in the engine): that
is what makes the TPU encode scan parallel over rows -- the moral
equivalent of the reference's independent-stream parallelism
(reference/scripts/app.js:351,521), applied *within* a frame, and
of config 4's multi-slice parallel encode in BASELINE.json.
"""

from __future__ import annotations

import dataclasses

from .bitstream import BitReader, BitWriter
from .params import PPS, SPS

SLICE_P = 0
SLICE_I = 2


@dataclasses.dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = SLICE_I  # 0..4; we emit type+5 variants (5..9)
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    # parse-only metadata (excluded from equality: write() does not
    # produce it): bit length of the header -- CABAC slice data starts
    # at the next byte boundary after it
    header_bits: int = dataclasses.field(default=0, compare=False)
    # explicit weighted prediction (parse only; None = unweighted):
    # weights_l0[ref] = (luma_w, luma_o, [[cb_w, cb_o], [cr_w, cr_o]])
    luma_log2_weight_denom: int = dataclasses.field(
        default=0, compare=False)
    chroma_log2_weight_denom: int = dataclasses.field(
        default=0, compare=False)
    weights_l0: object = dataclasses.field(default=None, compare=False)
    # ref_pic_list_modification ops (parse only; None = default order):
    # [(modification_of_pic_nums_idc 0|1, abs_diff_pic_num_minus1), ...]
    ref_list_mods: object = dataclasses.field(default=None, compare=False)
    disable_deblocking_filter_idc: int = 1  # 1 = deblocking off
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0

    def write(
        self, w: BitWriter, sps: SPS, pps: PPS, idr: bool, ref: bool = True
    ) -> None:
        """`ref` False = non-reference picture (nal_ref_idc 0): the
        dec_ref_pic_marking syntax is absent (7.3.3, temporal SVC
        enhancement-layer frames)."""
        w.ue(self.first_mb_in_slice)
        # type+5 asserts "all slices in this picture have this type"
        w.ue(self.slice_type + 5)
        w.ue(self.pic_parameter_set_id)
        w.u(sps.log2_max_frame_num_minus4 + 4, self.frame_num)
        if idr:
            w.ue(self.idr_pic_id)
        if sps.pic_order_cnt_type == 0:
            bits = sps.log2_max_pic_order_cnt_lsb_minus4 + 4
            w.u(bits, (2 * self.frame_num) & ((1 << bits) - 1))  # pic_order_cnt_lsb
        if self.slice_type == SLICE_P:
            override = int(
                self.num_ref_idx_l0_active_minus1
                != pps.num_ref_idx_l0_default_active_minus1
            )
            w.u(1, override)
            if override:
                w.ue(self.num_ref_idx_l0_active_minus1)
            w.u(1, 0)  # ref_pic_list_modification_flag_l0
        if idr:
            w.u(1, 0)  # no_output_of_prior_pics_flag
            w.u(1, 0)  # long_term_reference_flag
        elif ref:
            w.u(1, 0)  # adaptive_ref_pic_marking_mode_flag
        if pps.entropy_coding_mode_flag and self.slice_type != SLICE_I:
            w.ue(0)  # cabac_init_idc
        w.se(self.slice_qp_delta)
        if pps.deblocking_filter_control_present_flag:
            w.ue(self.disable_deblocking_filter_idc)
            if self.disable_deblocking_filter_idc != 1:
                w.se(self.slice_alpha_c0_offset_div2)
                w.se(self.slice_beta_offset_div2)

    @classmethod
    def parse(
        cls, r: BitReader, sps: SPS, pps: PPS, idr: bool, ref: bool = True
    ) -> "SliceHeader":
        h = cls()
        h.first_mb_in_slice = r.ue()
        h.slice_type = r.ue() % 5
        h.pic_parameter_set_id = r.ue()
        h.frame_num = r.u(sps.log2_max_frame_num_minus4 + 4)
        if idr:
            h.idr_pic_id = r.ue()
        if sps.pic_order_cnt_type == 0:
            r.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            if pps.bottom_field_pic_order_in_frame_present_flag:
                r.se()  # delta_pic_order_cnt_bottom
        h.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_active_minus1
        if h.slice_type == SLICE_P:
            if r.u(1):
                h.num_ref_idx_l0_active_minus1 = r.ue()
            if r.u(1):  # ref_pic_list_modification_flag_l0 (7.3.3.1)
                h.ref_list_mods = []
                while True:
                    idc = r.ue()
                    if idc == 3:
                        break
                    if idc == 2:
                        raise NotImplementedError(
                            "long-term ref_pic_list_modification"
                        )
                    h.ref_list_mods.append((idc, r.ue()))
            if pps.weighted_pred_flag:
                # pred_weight_table (7.3.3.2): explicit weighted
                # prediction, on by default in x264 main/high (weightp);
                # weights recorded per ref for the recon (8.4.2.3.2)
                luma_d = r.ue()
                chroma_d = r.ue()
                h.luma_log2_weight_denom = luma_d
                h.chroma_log2_weight_denom = chroma_d
                h.weights_l0 = []
                for _ in range(h.num_ref_idx_l0_active_minus1 + 1):
                    lw, lo = 1 << luma_d, 0
                    if r.u(1):  # luma_weight_l0_flag
                        lw, lo = r.se(), r.se()
                    cw = [[1 << chroma_d, 0], [1 << chroma_d, 0]]
                    if r.u(1):  # chroma_weight_l0_flag
                        for c in range(2):
                            cw[c][0], cw[c][1] = r.se(), r.se()
                    h.weights_l0.append((lw, lo, cw))
        if idr:
            r.u(1)
            if r.u(1):
                raise NotImplementedError("long-term reference")
        elif ref:
            if r.u(1):
                raise NotImplementedError("adaptive ref pic marking")
        if pps.entropy_coding_mode_flag and h.slice_type != SLICE_I:
            h.cabac_init_idc = r.ue()
        h.slice_qp_delta = r.se()
        if pps.deblocking_filter_control_present_flag:
            h.disable_deblocking_filter_idc = r.ue()
            if h.disable_deblocking_filter_idc != 1:
                h.slice_alpha_c0_offset_div2 = r.se()
                h.slice_beta_offset_div2 = r.se()
        h.header_bits = r._pos
        return h
