"""Synthetic corpus and query streams (numpy; same seeds as `repro.data`),
and the live corpus: `LiveCorpus` over its checksummed write-ahead log
(`WalWriter`, `replay`), on the reference's on-disk format.

Re-exports the public names of `repro.data` that the port has, in the
reference's order. Not ported yet: `tokens` (`TokenPipeline`,
`batch_struct`; ROADMAP Queue 1 item 5).
"""
from repro_torch.data.corpus import WMDData, make_corpus, zipf_query_stream
from repro_torch.data.live_corpus import LiveCorpus
from repro_torch.data.wal import WalWriter, replay

__all__ = ["WMDData", "make_corpus", "zipf_query_stream", "LiveCorpus",
           "WalWriter", "replay"]
