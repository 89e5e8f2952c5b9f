"""Synthetic corpus and query streams (numpy; same seeds as `repro.data`),
the live corpus: `LiveCorpus` over its checksummed write-ahead log
(`WalWriter`, `replay`), on the reference's on-disk format, and the
synthetic LM token pipeline (`TokenPipeline`, `batch_struct`).

Re-exports every public name of `repro.data`, in the reference's order.
"""
from repro_torch.data.corpus import WMDData, make_corpus, zipf_query_stream
from repro_torch.data.live_corpus import LiveCorpus
from repro_torch.data.tokens import TokenPipeline, batch_struct
from repro_torch.data.wal import WalWriter, replay

__all__ = ["WMDData", "make_corpus", "zipf_query_stream", "TokenPipeline",
           "batch_struct", "LiveCorpus", "WalWriter", "replay"]
