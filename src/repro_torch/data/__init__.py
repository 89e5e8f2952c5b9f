"""Synthetic corpus and query streams (numpy; same seeds as `repro.data`).

Re-exports the public names of `repro.data` that the port has, in the
reference's order. Not ported yet: `tokens` (`TokenPipeline`,
`batch_struct`; ROADMAP Queue 1 item 5), `live_corpus` and `wal`
(`LiveCorpus`, `WalWriter`, `replay`; item 2).
"""
from repro_torch.data.corpus import WMDData, make_corpus, zipf_query_stream

__all__ = ["WMDData", "make_corpus", "zipf_query_stream"]
