"""wenet_tpu — a JAX/XLA rebuild of the Wenet
high-altitude-balloon imagery downlink framework (projecthorus/wenet).

Layer map (mirrors SURVEY.md section 1, re-architected for an accelerator):

  core/      wire formats: framing, CRC, scramblers, LDPC code tables,
             application packet formats (pure numpy, host side)
  ops/       device compute: FSK mod/demod, LDPC encode/decode, deframing,
             channel models (JAX)
  parallel/  mesh construction, sharded Monte-Carlo sweeps, collectives
  rx/        receive application layer: packet router, SSDV assembly,
             modem stats bus, uploader/web-GUI compatible UDP emitters
  tx/        transmit application layer: packet framing/queues, fake radios
  native/    C host-side runtime pieces (stream ingest, CRC, deframe FSM)
  utils/     probes/tracing, config
"""

__version__ = "0.1.0"
