"""Radio backends for the TX stack.

The reference drives an RFM98W over SPI with UART (v1) or I2S (v2)
modulation (tx/radio_wrappers.py).  Here the radio abstraction keeps the
same contract — `scramble(body)`, `transmit_packet(frame)`, `shutdown()` —
with software backends:

  * IQRadio        — synthesizes the actual FSK IQ waveform (the in-process
                     "transmitter"): continuous phase across packets, sink =
                     file / callback / in-memory buffer
  * BinaryDebugRadio — one-byte-per-bit files for the C fsk modulator
                     (radio_wrappers.py:544-563 parity)
  * UDPRadio       — framed packets over UDP (tx/examples/
                     wenet_link_emulation.py equivalent, zero-RF testing)

plus the two actual on-air hardware paths of the reference:

  * RFM98W_Serial  — v1: framed bytes written to a UART whose TX line keys
                     the RFM98W's DIO2 pin; the UART's own 10-bit framing
                     (start + 8 data LSB-first + stop) IS the v1 RS232
                     on-air expansion (radio_wrappers.py:214-280)
  * RFM98W_I2S     — v2: each byte expanded MSB-first into bytes_per_bit
                     0xFF/0x00 bytes and streamed out of the Pi's I2S data
                     line via ALSA at an audio rate chosen so the line
                     toggles at exactly the baud rate
                     (radio_wrappers.py:283-460; deploy/i2smaster.dts)

serial/alsaaudio are import-gated: on this platform the transports accept
any object with write() so the exact byte streams are testable; the
modulation byte streams are oracle-verified against drs232_ldpc/wenet_ldpc
in tests/test_tx_transports.py.
"""
from __future__ import annotations

import socket

import numpy as np

from ..core import framing
from ..ops import fsk


# --------------------------------------------------------- I2S bit plumbing

I2S_CHANNELS = 2          # stereo frame on the PCM bus
I2S_WIDTH_BYTES = 2       # S16 samples
_I2S_RATES = (8000, 16000, 22050, 44100, 48000, 96000, 176400, 192000)


def i2s_audio_params(baudrate: int) -> tuple[int, int]:
    """Pick the lowest standard audio rate whose I2S line bit rate is a
    whole number of BYTES per modem bit (radio_wrappers.py:302-332).
    Returns (audio_rate_hz, bytes_per_modem_bit)."""
    for rate in _I2S_RATES:
        line_bps = rate * I2S_CHANNELS * I2S_WIDTH_BYTES * 8
        if line_bps % (8 * baudrate) == 0 and line_bps >= 8 * baudrate:
            return rate, line_bps // (8 * baudrate)
    raise ValueError(f"baudrate {baudrate} not representable on the I2S bus")


def i2s_expand(data: bytes, bytes_per_bit: int) -> bytes:
    """Byte stream -> I2S sample bytes: bits MSB-first, each repeated as
    bytes_per_bit 0xFF/0x00 bytes (the byte->samples LUT of
    radio_wrappers.py:407-417, vectorised)."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    return np.repeat(bits * np.uint8(0xFF), bytes_per_bit).tobytes()


def i2s_line_bits(stream: bytes, bytes_per_bit: int) -> np.ndarray:
    """Inverse of i2s_expand: recover the modem bits the RF sees on DIO2."""
    b = np.frombuffer(stream, np.uint8)[::bytes_per_bit]
    return (b > 0x7F).astype(np.uint8)


class _RadioBase:
    mode = "v2"

    def scramble(self, body: bytes) -> bytes:
        """v2 radios XOR-scramble the post-UW body (radio_wrappers.py:385-405);
        v1 serial radios transmit it raw."""
        if self.mode == "v2":
            return framing.tx_scramble(body)
        return body

    def transmit_packet(self, frame: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class IQRadio(_RadioBase):
    """Synthesize the on-air complex baseband waveform for each packet.

    sink: callable(np.complex64 array) — e.g. file writer, channel model,
    or a live Receiver for closed-loop tests.
    """

    def __init__(self, sink, cfg: fsk.FSKConfig | None = None,
                 mode: str = "v2", f1: int | None = None,
                 shift: int | None = None, amplitude: float = 1.0):
        self.mode = mode
        self.cfg = (fsk.V2_CONFIG if mode == "v2" else fsk.V1_CONFIG) \
            if cfg is None else cfg
        self.f1 = 2 * self.cfg.Rs if f1 is None else f1
        # deviation = baud/2 => tone spacing = baud (radio_wrappers.py:95-104)
        self.shift = self.cfg.Rs if shift is None else shift
        self.sink = sink
        self.amplitude = amplitude
        self._phase_acc = 0

    def transmit_packet(self, frame: bytes) -> None:
        bits = framing.frame_to_bits(frame, self.mode)
        pad = (-len(bits)) % (2 if self.cfg.M == 4 else 1)
        if pad:
            bits = np.concatenate([bits, np.ones(pad, np.uint8)])
        sig, self._phase_acc = fsk.fsk_mod_np(
            self.cfg, bits, self.f1, self.shift, phase_acc=self._phase_acc)
        self.sink((0.5 * self.amplitude * sig).astype(np.complex64))


class RFM98W_IQ(IQRadio):
    """IQRadio configured through a register-level RFM98W driver.

    The register file (or real SPI transport) is programmed exactly as the
    reference programs the hardware (radio_wrappers.py:85-139); the FSK
    tone spacing used for synthesis is then *read back from the registers*
    (2x deviation), so tests exercise the true config path.  Also carries
    the reference's per-5000-packet re-init behavior.
    """

    def __init__(self, sink, frequency_hz: float = 443.5e6,
                 baudrate: int | None = None, tx_power_dbm: int = 10,
                 mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 transport=None, reinit_count: int = 5000):
        from . import sx127x
        base_cfg = (fsk.V2_CONFIG if mode == "v2" else fsk.V1_CONFIG) \
            if cfg is None else cfg
        baud = base_cfg.Rs if baudrate is None else baudrate
        self.radio = sx127x.RFM98W(
            frequency_hz=frequency_hz, baudrate=baud,
            tx_power_dbm=tx_power_dbm, reinit_count=reinit_count,
            transport=transport)
        if not self.radio.start():
            raise RuntimeError("RFM98W failed to initialise")
        regs = self.radio.lora.spi
        shift = (int(round(2 * regs.deviation_hz()))
                 if isinstance(regs, sx127x.RegisterFile) else baud)
        super().__init__(sink, cfg=base_cfg, mode=mode, shift=shift)

    def transmit_packet(self, frame: bytes) -> None:
        super().transmit_packet(frame)
        self.radio.on_packet_transmitted()

    def shutdown(self) -> None:
        self.radio.shutdown()


class BinaryDebugRadio(_RadioBase):
    """Write packets as one-byte-per-bit files (0x00/0x01) for codec2's fsk
    modulator — the reference's BinaryDebug fake radio."""

    def __init__(self, path: str, mode: str = "v1"):
        self.mode = mode
        self._f = open(path, "wb")

    def transmit_packet(self, frame: bytes) -> None:
        bits = framing.frame_to_bits(frame, self.mode)
        self._f.write(bits.astype(np.uint8).tobytes())

    def shutdown(self) -> None:
        self._f.close()


class _RS232DebugFile:
    """Fallback 'UART': writes the 10-bit RS232 expansion one byte per bit
    (0x00/0x01) for codec2's fsk modulator — what the reference's
    BinaryDebug does when no serial port is given (radio_wrappers.py:
    544-563, 251-253)."""

    def __init__(self, path: str = "binary_debug.bin"):
        self._f = open(path, "wb")

    def write(self, data: bytes):
        self._f.write(framing.rs232_expand(data).tobytes())

    def close(self):
        self._f.close()


class RFM98W_Serial(_RadioBase):
    """v1 on-air path: RFM98W in direct-asynchronous FSK mode keyed by a
    UART TX line on DIO2 (radio_wrappers.py:214-280).

    transmit_packet writes the framed bytes straight to the serial device;
    the UART's hardware framing (start bit + 8 data bits LSB-first + stop
    bit) performs the v1 RS232 expansion on the wire, so the on-air bit
    stream is framing.rs232_expand(frame). The SX127x is configured through
    the register-level driver (frequency, deviation table, power LUT) and
    re-initialised every `reinit_count` packets like the reference.

    transport: any object with write(bytes) (a pyserial Serial, a file,
    an in-memory sink for tests). serial_port opens pyserial. With
    neither, falls back to an RS232-bit debug file as the reference does.
    """

    mode = "v1"

    def __init__(self, transport=None, serial_port: str | None = None,
                 baudrate: int = 115200, frequency_hz: float = 443.5e6,
                 tx_power_dbm: int = 10, reinit_count: int = 5000,
                 spi_transport=None):
        from . import sx127x
        self.radio = sx127x.RFM98W(
            frequency_hz=frequency_hz, baudrate=baudrate,
            tx_power_dbm=tx_power_dbm, reinit_count=reinit_count,
            transport=spi_transport)
        if not self.radio.start():
            raise RuntimeError("RFM98W failed to initialise")
        if transport is not None:
            self.serial = transport
        elif serial_port:  # pragma: no cover - hardware only
            import serial
            self.serial = serial.Serial(serial_port, baudrate)
        else:
            self.serial = _RS232DebugFile()

    def transmit_packet(self, frame: bytes) -> None:
        self.serial.write(frame)
        self.radio.on_packet_transmitted()

    def shutdown(self) -> None:
        try:
            self.serial.close()
        except Exception:
            pass
        self.radio.shutdown()


class RFM98W_I2S(_RadioBase):
    """v2 on-air path: RFM98W keyed by the Pi's I2S data line via ALSA
    (radio_wrappers.py:283-460; the Pi is made I2S clock master by
    deploy/i2smaster.dts so the line toggles at an exact rate).

    Each framed byte expands MSB-first to `bytes_per_bit` 0xFF/0x00 sample
    bytes; at the chosen audio rate the PCM bus shifts one modem bit per
    1/baud. The post-UW body is XOR-scrambled by _RadioBase.scramble
    (mode 'v2').

    pcm: any object with write(bytes) (optionally setperiodsize/setrate/
    setchannels) — an alsaaudio.PCM, or an in-memory sink for tests.
    """

    mode = "v2"

    def __init__(self, pcm=None, audio_device: str = "hw:CARD=i2smaster,DEV=0",
                 baudrate: int = 96000, frequency_hz: float = 443.5e6,
                 tx_power_dbm: int = 10, reinit_count: int = 5000,
                 spi_transport=None):
        from . import sx127x
        self.audio_rate, self.bytes_per_bit = i2s_audio_params(baudrate)
        self.radio = sx127x.RFM98W(
            frequency_hz=frequency_hz, baudrate=baudrate,
            tx_power_dbm=tx_power_dbm, reinit_count=reinit_count,
            transport=spi_transport)
        if not self.radio.start():
            raise RuntimeError("RFM98W failed to initialise")
        if pcm is not None:
            self.pcm = pcm
        else:  # pragma: no cover - hardware only
            import alsaaudio
            self.pcm = alsaaudio.PCM(device=audio_device)
            if self.pcm.setrate(self.audio_rate) != self.audio_rate:
                raise RuntimeError("could not set I2S audio rate")
            if self.pcm.setchannels(I2S_CHANNELS) != I2S_CHANNELS:
                raise RuntimeError("could not set I2S channel count")
        self._periodsize = None

    def transmit_packet(self, frame: bytes) -> None:
        buf = i2s_expand(frame, self.bytes_per_bit)
        nframes = len(buf) // (I2S_CHANNELS * I2S_WIDTH_BYTES)
        if self._periodsize != nframes and hasattr(self.pcm, "setperiodsize"):
            self.pcm.setperiodsize(nframes)      # one ALSA period per packet
            self._periodsize = nframes
        self.pcm.write(buf)
        self.radio.on_packet_transmitted()

    def shutdown(self) -> None:
        try:
            self.pcm.close()
        except Exception:
            pass
        self.radio.shutdown()


class UDPRadio(_RadioBase):
    """Emit framed packets as UDP datagrams (RF-free link emulation)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 55674,
                 mode: str = "v2"):
        self.mode = mode
        self.addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def transmit_packet(self, frame: bytes) -> None:
        self._sock.sendto(frame, self.addr)

    def shutdown(self) -> None:
        self._sock.close()
