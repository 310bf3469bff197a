"""mesh.busy_spread_pct (%): the busiest card's device-busy time in the
traced window minus the idlest card's, over their mean: the imbalance of
the shard plan."""


def read(run):
    if run.events is None or len(run.devices) < 2:
        return None
    busy = [run.busy_s(d) for d in run.devices]
    mean = sum(busy) / len(busy)
    return 100.0 * (max(busy) - min(busy)) / mean if mean > 0 else None
