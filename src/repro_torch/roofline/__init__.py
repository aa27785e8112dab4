from repro_torch.roofline.analysis import (  # noqa: F401
    HW, CostLedger, bound, collective_bytes_from_counts, launch_cost,
    model_flops_estimate, roofline_terms, use_ledger)
