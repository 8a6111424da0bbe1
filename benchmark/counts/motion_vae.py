"""FLOPs of ACTOR's transformer motion decoder as the MotionOptimizer runs
it (a multiply-add counted as 2): T frame queries, d wide, through post-LN
layers of self-attention, cross-attention to the latent as M = 1 memory
token and a feed-forward of ff, then the linear map to 55 x 6 features.
The matrix products alone: the layer norms, GELU, softmax and the rotation
chain are elementwise (under a thousandth of the products)."""

from __future__ import annotations


def _dims(cfg: dict) -> tuple[int, int, int, int, int]:
    """(T, d, ff, layers, output features)."""
    return (int(cfg["num_frame"]), int(cfg["latent_dim"]), int(cfg["ff_size"]), int(cfg["num_layers"]),
            int(cfg["n_joints"]) * 6)


def _layer(T: int, d: int, ff: int, M: int = 1) -> dict:
    """One layer's forward products by part: (linear, attention) FLOPs."""
    return {"self": (2 * T * d * 3 * d + 2 * T * d * d, 2 * 2 * T * T * d),
            "cross": (2 * T * d * d + 2 * M * d * 2 * d + 2 * T * d * d, 2 * 2 * T * M * d),
            "ffn": (2 * 2 * T * d * ff, 0)}


def layer_forward_flops(T: int, d: int, ff: int) -> float:
    return float(sum(a + b for a, b in _layer(T, d, ff).values()))


def decoder_forward_flops(cfg: dict) -> float:
    T, d, ff, L, out = _dims(cfg)
    return L * layer_forward_flops(T, d, ff) + 2.0 * T * d * out


def decoder_input_grad_flops(cfg: dict) -> float:
    """The gradient with respect to the latent alone (the weights are
    frozen). A linear product's input gradient costs its forward again;
    the attention scores' and weighted sums' gradients reach both of their
    operands where both depend on the latent (twice their forward). In the
    first layer the queries are the positional encoding, a constant: its
    self-attention and its cross-attention's query projection need no
    gradient, its cross-attention scores reach the keys alone and its
    weighted sums both the weights and the values."""
    T, d, ff, L, out = _dims(cfg)
    M = 1
    full = sum(a + 2 * b for a, b in _layer(T, d, ff, M).values())
    first = (2 * M * d * 2 * d + 2 * T * d * d  # the memory's keys and values, the output projection
             + 2 * T * M * d + 2 * 2 * T * M * d  # scores to the keys; sums to the weights and the values
             + 2 * 2 * T * d * ff)
    return float(first + (L - 1) * full + 2 * T * d * out)


def decoder_train_flops(cfg: dict) -> float:
    """A step's decoder: its forward and the latent's gradient."""
    return decoder_forward_flops(cfg) + decoder_input_grad_flops(cfg)
