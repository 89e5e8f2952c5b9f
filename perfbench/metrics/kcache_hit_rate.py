"""kcache_hit_rate: K-cache rows served from the resident store over all
rows looked up in the window (hit_rows / (hit_rows + miss_rows))."""


def read(m):
    hits, misses = m["kcache"]
    if hits + misses == 0:
        return None
    return hits / (hits + misses)
