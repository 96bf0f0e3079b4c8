"""K1 (flash attention, ``kernels/flash_attention``) over the traced
prefills: its calls' least time (causal, 2 (Dqk + Dv) flop a visible
pair, Dv the configuration's ``v_head_dim`` where it states one: MLA pads
v to the qk width before the call, and the padding is no work) over the
device time of the kernels named below."""
from perfbench.harness import work
from perfbench.harness.readers import roofline_pct

KERNELS = ("attn_ws_kernel", "attn_bf16_kernel", "attn_f32_kernel")


def read(rec):
    dv = rec.cfg.get("v_head_dim")
    return roofline_pct(rec, "prefill", "flash_attention", KERNELS,
                        lambda ops, res: work.flash_attention_work(
                            ops, res, dv=dv))
