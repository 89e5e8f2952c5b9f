"""peer_copy_share: the device seconds of the copies between cards
(torch.profiler names them "Memcpy PtoP (Device -> Device)") among the
stretch's largest device operations, summed over the cards, over the
traced stretch's seconds. None on one card; 0.0 on several when no such
copy is listed. A lower bound: ``device_ops`` holds only the stretch's 10
largest operations (`devtime.read_stretch`), so a copy that falls out of
them reads as 0.0."""


def read(m):
    t = m.get("trace")
    if not t or t["window_s"] <= 0 or len(t.get("busy_s_by_card") or []) < 2:
        return None
    return sum(s for name, s in t["device_ops"] if "PtoP" in name) \
        / t["window_s"]
