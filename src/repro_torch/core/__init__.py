"""HGQ core (forward half): quantizer grids, ~EBOPs terms, layer glue,
precision plans."""
from .quantizer import (f_shape_for, group_size, int_bits_from_range,
                        quantize_inference, train_bits)
from .hgq import (CALIB, EVAL, TRAIN, ActState, Aux, QTensor, matmul_ebops,
                  observe, quant_act, quant_weight)
from .plan import NIBBLE_BITS, LayerPlan, PrecisionPlan

__all__ = ["ActState", "Aux", "CALIB", "EVAL", "LayerPlan", "NIBBLE_BITS",
           "PrecisionPlan", "QTensor", "TRAIN", "f_shape_for", "group_size",
           "int_bits_from_range", "matmul_ebops", "observe", "quant_act",
           "quant_weight", "quantize_inference", "train_bits"]
