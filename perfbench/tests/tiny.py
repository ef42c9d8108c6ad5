"""Small configurations and mixes for the CPU tests: the cells' shapes
cut to a size a test run holds, in float32 (the program's plain path on
the CPU)."""

DENSE = {"name": "tiny-dense", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 300, "rope_theta": 100000.0,
         "norm_eps": 1e-6, "tie_embeddings": False, "dtype": "float32"}

MOE = {"name": "tiny-moe", "family": "moe", "num_layers": 2, "d_model": 64,
       "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 32,
       "vocab_size": 301, "num_experts": 8, "experts_per_token": 2,
       "rope_theta": 10000.0, "norm_eps": 1e-6, "tie_embeddings": True,
       "dtype": "float32"}

SERVE = {"kind": "closed_loop", "clients": 4, "slots": 4, "cache_len": 40,
         "round": 4, "prompt_len": {"dist": "log_uniform", "lo": 8,
                                    "hi": 32},
         "max_new": {"dist": "uniform", "lo": 2, "hi": 6},
         "schedule_seed": 1, "check_requests": 3}

TRAIN = {"kind": "train", "batch": 4, "seq": 16, "remat": True,
         "lr": 3e-4, "capacity_factor": 1.25}


def scaled(mix: dict) -> dict:
    """A cell's traffic mix cut to a size a CPU test holds: the same kind
    and distributions, lengths and counts divided down."""
    mix = dict(mix)
    if mix["kind"] == "closed_loop":
        p, n = dict(mix["prompt_len"]), dict(mix["max_new"])
        p["lo"], p["hi"] = max(2, p["lo"] // 256), max(3, p["hi"] // 256)
        n["lo"], n["hi"] = max(2, n["lo"] // 8), max(3, n["hi"] // 8)
        mix.update(clients=4, slots=4, round=4, prompt_len=p, max_new=n,
                   cache_len=p["hi"] + n["hi"], check_requests=3)
    else:
        mix.update(batch=max(2, mix["batch"] // 2),
                   seq=max(8, mix["seq"] // 256))
    return mix


#: the dense configuration with every layer on a sliding window shorter
#: than the scaled prompts
DENSE_LOCAL = dict(DENSE, name="tiny-dense-local", pattern=["local"],
                   window_size=8, rope_theta_local=100000.0)


def cell_parts(workload: str) -> tuple:
    """(tiny configuration file, scaled mix) standing in for a cell's: of
    its family, with sliding windows where it has them."""
    from harness import manifest
    wl = manifest.workload(workload)
    mix = manifest.traffic(wl["traffic"])
    real = manifest.config(wl["config"])["program"]
    prog = (MOE if real.get("num_experts") else
            DENSE_LOCAL if "local" in real.get("pattern", []) else DENSE)
    return {"program": prog}, scaled(mix)
