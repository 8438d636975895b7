"""Small versions of the cells for the CPU tests: the cells' own files
with the widths and the traffic cut to what a test run holds, and limits
of their own, set as the cells' were, from readings at this size (8
seeds, the port's plain CPU path against the reference, and the fp8
control): served_logit_gap 0 to 0.0088 (control 0.26 to 0.41);
first_grad_gap 1.5e-4 to 3.6e-4 (control 0.010 to 0.036); loss_gap
0.0029 to 0.023 (control 0.0045 to 0.030) and change_gap 0.0091 to 0.036
(control 0.014 to 0.077) do not separate at this size, so they are held
loosely, above the port's readings (a state left unchanged reads 1 on
change_gap)."""

SMALL_LIMITS = {
    "serve": {"served_logit_gap": 0.05},
    "train": {"loss_gap": 0.1, "first_grad_gap": 0.002, "change_gap": 0.2},
}
from bench.harness import BENCH, load_json


def cell(name: str):
    """(cell dict, configuration dict) of ``name`` at a CPU test size."""
    c = load_json(BENCH / "cells" / f"{name}.json")
    if c["system"] == "train":
        cfg = load_json(BENCH / "configs" / "falcon-mamba-7b-d16.json")
        cfg["model"].update(n_layers=2, d_model=64, d_inner=128, dt_rank=8,
                            ssm_state=4, vocab_size=256)
        c["traffic_params"].update(batch=4, seq=32)
        c["check"]["limits"] = dict(SMALL_LIMITS["train"])
        return c, cfg
    cfg = load_json(BENCH / "configs" / "qwen2.5-14b.json")
    cfg["model"].update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=32, d_ff=256, vocab_size=512)
    c["engine"]["max_len"] = 96
    c["session"]["lanes"] = 4
    c["traffic_params"].update(clients=4, prompt_len=[20, 60],
                               output_len=[8, 30])
    c["check"]["limits"] = dict(SMALL_LIMITS["serve"])
    return c, cfg
