"""The attention sub-block's share of its roofline in training: the least
time a step's model FLOPs and bytes of it allow (``counts.least_time_s``)
over the exclusive device ms a step of the program's ranges ``attn``,
``attn.latent`` and ``attn.bwd`` in the ranges-only window
(``perfbench.attribution``).

Counted from the weight tree (``weights.shapes``) and the traffic's shape,
whatever the attention's kind: FLOPs, 6 a weight a token for every product
leaf under an ``attn`` key (forward, and twice that backward), and the
causal scores and weighted sums at ``qk_head_dim`` and ``v_head_dim``
(``head_dim`` by default) forward and twice that backward, over
``attention_layers`` (every layer by default); nothing recomputed is
counted.  Bytes: those weights read forward and backward and their
gradient written, and each layer's input and output once forward and its
input, the output's gradient and the input's gradient once backward."""
import math

from perfbench import attribution, counts, weights

RANGES = ("attn", "attn.latent", "attn.bwd")


def step_counts(c, batch: int, seq: int):
    """(FLOPs, bytes) of one training step's attention sub-blocks."""
    proj = sum(math.prod(shape) for path, (shape, kind)
               in weights.leaf_paths(weights.shapes(c))
               if "attn/" in path and kind in weights.PRODUCTS)
    layers = c.get("attention_layers", c["num_layers"])
    tokens = batch * seq
    width = c.get("qk_head_dim", c["head_dim"]) + c.get("v_head_dim", c["head_dim"])
    attn_fwd = 2 * batch * c["num_heads"] * width * (seq * (seq + 1) // 2)
    flops = 6.0 * proj * tokens + 3.0 * layers * attn_fwd
    nbytes = counts.DTYPE_BYTES[c["dtype"]] * (
        3.0 * proj + 5.0 * tokens * c["d_model"] * layers)
    return flops, nbytes


def read(run):
    ms = attribution.device_ms(run, RANGES)
    if ms is None:
        return None
    flops, nbytes = step_counts(run.cfg, run.spec["batch"], run.spec["seq_len"])
    return 100.0 * counts.least_time_s(flops, nbytes) * 1e3 / ms
