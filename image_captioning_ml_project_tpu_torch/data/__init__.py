"""Host-side data code of the port: the word vocabulary, the COCO caption
dataset and its batching, the synthetic fixture, and the prefetch that
moves batches to the device."""
