"""HGQ core: the trainable-bitwidth quantizer, ~EBOPs terms, layer glue,
calibration and the fixed-point proxy, Pareto fronts, schedules,
precision plans."""
from .quantizer import (LN2, QuantizerSpec, f_shape_for, grad_scale,
                        group_occupied_bits, group_size, int_bits_from_range,
                        occupied_bits, quantize, quantize_inference,
                        ste_round, train_bits)
from .ebops import (ebops_conv2d, ebops_dyn_matmul, ebops_matmul, l1_bits,
                    loss_with_resource, useful_model_flops_dense)
from .hgq import (CALIB, EVAL, TRAIN, ActState, Aux, QTensor,
                  dyn_matmul_ebops, init_act_state, matmul_ebops, observe,
                  quant_act, quant_weight)
from .calibrate import (FixedSpec, assert_no_overflow, fixed_spec_for_weights,
                        fixed_spec_from_range, int_bits_exact)
from .fixedpoint import representable, to_fixed
from .pareto import ParetoFront, ParetoPoint
from .plan import (NIBBLE_BITS, LayerPlan, PrecisionPlan, iter_packable,
                   layer_occupied_bits, mixed_low_plan, plan_from_params)
from .schedule import constant, linear_warmup_cosine, log_ramp

__all__ = ["ActState", "Aux", "CALIB", "EVAL", "FixedSpec", "LN2",
           "LayerPlan", "NIBBLE_BITS", "ParetoFront", "ParetoPoint",
           "PrecisionPlan", "QTensor", "QuantizerSpec", "TRAIN",
           "assert_no_overflow", "constant", "dyn_matmul_ebops",
           "ebops_conv2d", "ebops_dyn_matmul", "ebops_matmul", "f_shape_for",
           "fixed_spec_for_weights", "fixed_spec_from_range", "grad_scale",
           "group_occupied_bits", "group_size", "init_act_state",
           "int_bits_exact", "int_bits_from_range", "iter_packable", "l1_bits",
           "layer_occupied_bits",
           "linear_warmup_cosine", "log_ramp", "loss_with_resource",
           "matmul_ebops", "mixed_low_plan", "observe", "occupied_bits",
           "plan_from_params", "quant_act",
           "quant_weight", "quantize", "quantize_inference", "representable",
           "ste_round", "to_fixed", "train_bits",
           "useful_model_flops_dense"]
