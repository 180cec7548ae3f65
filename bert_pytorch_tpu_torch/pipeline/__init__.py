"""The offline corpus pipeline: format -> shard -> vocab -> encode
(counterpart of bert_pytorch_tpu/pipeline, the same outputs).

Each module is import-usable and a CLI
(python -m bert_pytorch_tpu_torch.pipeline.<step>). The encoder writes the
gzip'd HDF5 schema data/sharded.py reads (input_ids i4,
special_token_positions i4, next_sentence_labels i1), or hands the same
arrays to a caller (encode.sample_arrays). Downloading corpora
(the JAX package's pipeline/download.py) needs the network and is not
ported.
"""
