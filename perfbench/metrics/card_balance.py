"""card_balance: the least over the greatest of the cards' busy seconds
over the traced stretch (torch.profiler's device events, each card's
merged): 1 when every card works as long as the others, lower when one
card (card 0's stripe copies and gather, or a larger shard) sets the pace.
None on one card."""


def read(m):
    t = m.get("trace")
    by = (t or {}).get("busy_s_by_card") or []
    if len(by) < 2 or max(by) <= 0:
        return None
    return min(by) / max(by)
