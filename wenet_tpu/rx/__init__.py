"""Receive-side application layer: pipeline assembly, packet routing, SSDV
image reassembly, stats buses — the in-process counterpart of the reference
rx/ process pipeline (start_rx.sh:125-150)."""
