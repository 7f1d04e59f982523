"""Host-side data code of the port: the word vocabulary and the GPT-2
byte-level BPE tokenizer, the COCO caption dataset and its batching, the
synthetic fixture, and the prefetch that moves batches to the device."""

from .bpe import GPT2BPETokenizer
