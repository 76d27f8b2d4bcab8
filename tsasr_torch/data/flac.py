"""Native FLAC codec (pure Python here; C++ fast path in the runtime).

The port's own copy of the JAX package's ``data/flac.py``, line for
line, with its imports pointed at ``tsasr_torch``.

LibriSpeech ships FLAC; the reference decodes it through torchaudio's C++
backend (``train_librispeechmix_scratch.py:344-348``). Neither torchaudio
nor libsndfile exists in this image, so this module implements the FLAC
format directly:

- ``read_flac``   — full decoder: constant / verbatim / fixed(0-4) / LPC
  subframes, Rice and Rice2 residual coding with escape partitions,
  wasted bits, all four channel assignments (independent, left/side,
  right/side, mid/side), UTF-8 frame numbers, variable block sizes.
- ``write_flac``  — encoder used by tools and tests (FLAC is lossless, so
  a round-trip pins the decoder bit-exactly): fixed-predictor order
  search + optional LPC (Levinson-Durbin), Rice residuals, CRC-8/CRC-16
  framing. Mono or independent stereo.

The C++ runtime mirrors ``read_flac`` (``native/tsasr_native.cpp``
``tsasr_flac_read``) as the data-loader hot path; this file is the
reference implementation and the fallback.
"""


import numpy as np

FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                     8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                     13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                      6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                      11: 96000}
_SAMPLE_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data, pos_bytes=0):
        self.data = data
        self.pos = pos_bytes * 8  # absolute bit position

    def read(self, n):
        """Read n bits as an unsigned int."""
        pos, data = self.pos, self.data
        end = pos + n
        first, last = pos >> 3, (end + 7) >> 3
        chunk = int.from_bytes(data[first:last], "big")
        chunk >>= (last << 3) - end
        self.pos = end
        return chunk & ((1 << n) - 1)

    def read_signed(self, n):
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self):
        """Count zero bits up to the terminating 1 bit."""
        count = 0
        pos, data = self.pos, self.data
        # scan byte-at-a-time for speed
        while True:
            byte_idx = pos >> 3
            if byte_idx >= len(data):
                raise EOFError("unary past end of stream")
            bit_off = pos & 7
            byte = data[byte_idx] & (0xFF >> bit_off)
            if byte:
                lead = 7 - byte.bit_length() + 1  # position of top set bit
                count += lead - bit_off
                self.pos = (byte_idx << 3) + lead + 1
                return count
            count += 8 - bit_off
            pos = (byte_idx + 1) << 3

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def at_end(self):
        return self.pos >= len(self.data) * 8

    def read_utf8_number(self):
        """FLAC's UTF-8-style coded number (up to 36 bits / 7 bytes)."""
        first = self.read(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        value = first & (mask - 1)
        for _ in range(n_extra):
            byte = self.read(8)
            value = (value << 6) | (byte & 0x3F)
        return value


class _BitWriter:
    """MSB-first bit writer."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value, n):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value, n):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self):
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data):
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data):
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


# =============================================================== decoder

def read_flac(path_or_bytes):
    """Decode a FLAC file -> (int32 samples (n, channels), sample_rate,
    bits_per_sample)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (bad magic)")
    pos = 4
    streaminfo = None
    while True:
        header = data[pos:pos + 4]
        last = header[0] >> 7
        btype = header[0] & 0x7F
        size = int.from_bytes(header[1:4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min block size
            br.read(16)  # max block size
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            streaminfo = (sample_rate, channels, bps, total)
        pos += 4 + size
        if last:
            break
    if streaminfo is None:
        raise ValueError("FLAC stream missing STREAMINFO")
    sr, n_channels, bps, total_samples = streaminfo

    br = _BitReader(data, pos)
    chans = [[] for _ in range(n_channels)]
    decoded = 0
    while not br.at_end() and (total_samples == 0 or decoded < total_samples):
        frame = _read_frame(br, streaminfo)
        if frame is None:
            break
        for c in range(n_channels):
            chans[c].append(frame[c])
        decoded += len(frame[0])
    out = np.stack([np.concatenate(c) for c in chans], axis=1)
    if total_samples:
        out = out[:total_samples]
    return out.astype(np.int32), sr, bps


def _read_frame(br, streaminfo):
    sr_info, n_channels, bps_info, _ = streaminfo
    sync = br.read(14)
    if sync != 0b11111111111110:
        raise ValueError(f"bad frame sync 0x{sync:04x}")
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_assign = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    br.read_utf8_number()
    if bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCK_SIZE_TABLE[bs_code]
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    bps = bps_info if ss_code == 0 else _SAMPLE_SIZE_TABLE[ss_code]
    br.read(8)  # CRC-8 (not verified; framing errors surface as bad sync)

    if ch_assign < 8:
        n_ch = ch_assign + 1
        subframes = [_read_subframe(br, block_size, bps)
                     for _ in range(n_ch)]
    else:
        # stereo decorrelation: the side channel carries one extra bit
        extra = {8: (0, 1), 9: (1, 0), 10: (0, 1)}[ch_assign]
        subframes = [_read_subframe(br, block_size, bps + extra[i])
                     for i in range(2)]
        a, b = subframes
        if ch_assign == 8:      # left/side
            subframes = [a, a - b]
        elif ch_assign == 9:    # right/side
            subframes = [b + a, b]
        else:                   # mid/side
            mid, side = a, b
            mid = (mid << 1) | (side & 1)
            subframes = [(mid + side) >> 1, (mid - side) >> 1]
    br.align()
    br.read(16)  # CRC-16
    return subframes


def _read_subframe(br, block_size, bps):
    if br.read(1):
        raise ValueError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted
    if stype == 0:       # constant
        v = br.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif stype == 1:     # verbatim
        out = np.array([br.read_signed(bps) for _ in range(block_size)],
                       np.int64)
    elif 8 <= stype <= 12:  # fixed
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _read_residual(br, block_size, order)
        out = _predict_fixed(order, warm, resid)
    elif stype >= 32:    # LPC
        order = stype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        resid = _read_residual(br, block_size, order)
        out = _predict_lpc(coefs, shift, warm, resid)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out = out << wasted
    return out


def _read_residual(br, block_size, order):
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    param_bits, escape = (4, 15) if method == 0 else (5, 31)
    part_order = br.read(4)
    n_parts = 1 << part_order
    out = np.empty(block_size - order, np.int64)
    filled = 0
    for p in range(n_parts):
        n = (block_size >> part_order) - (order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            for i in range(n):
                out[filled + i] = br.read_signed(raw_bits) if raw_bits else 0
        else:
            for i in range(n):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                out[filled + i] = (v >> 1) ^ -(v & 1)
        filled += n
    return out


def _predict_fixed(order, warm, resid):
    """Invert the order-k finite difference by iterated cumsum (the fixed
    predictors are exactly the binomial difference filters)."""
    if order == 0:
        return resid.copy()
    warm = np.asarray(warm, np.int64)
    seq = resid
    for level in range(order - 1, -1, -1):
        init = np.diff(warm, n=level)[-1] if level else warm[-1]
        seq = init + np.cumsum(seq)
    return np.concatenate([warm, seq])


def _predict_lpc(coefs, shift, warm, resid):
    order = len(coefs)
    n = order + len(resid)
    out = np.empty(n, np.int64)
    out[:order] = warm
    for i in range(order, n):
        acc = 0
        for j, c in enumerate(coefs):
            acc += c * int(out[i - 1 - j])
        out[i] = resid[i - order] + (acc >> shift)
    return out


# =============================================================== encoder

def write_flac(path, data, sample_rate, bps=16, block_size=4096,
               use_lpc=True, lpc_order=8):
    """Encode int PCM -> FLAC file. ``data``: (n,) or (n, channels) int
    array within [-2^(bps-1), 2^(bps-1)). Lossless: decoding returns the
    exact samples."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n, channels = data.shape
    data = data.astype(np.int64)

    payload = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + b"\x00" * 16  # md5 unset
    payload += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for fi, start in enumerate(range(0, n, block_size)):
        block = data[start:start + block_size]
        payload += _encode_frame(block, fi, sample_rate, bps, block_size,
                                 use_lpc, lpc_order)
    with open(path, "wb") as f:
        f.write(bytes(payload))


def _encode_frame(block, frame_idx, sample_rate, bps, nominal_bs,
                  use_lpc, lpc_order):
    bs = len(block)
    w = _BitWriter()
    w.write(0b11111111111110, 14)
    w.write(0, 1)
    w.write(0, 1)  # fixed blocksize strategy
    if bs == nominal_bs and nominal_bs in _BLOCK_SIZE_TABLE.values():
        code = next(k for k, v in _BLOCK_SIZE_TABLE.items() if v == bs)
        w.write(code, 4)
        bs_tail = None
    else:
        w.write(7, 4)
        bs_tail = bs - 1
    sr_code = next((k for k, v in _SAMPLE_RATE_TABLE.items()
                    if v == sample_rate), 0)
    w.write(sr_code, 4)
    w.write(block.shape[1] - 1, 4)  # independent channels
    ss_code = next((k for k, v in _SAMPLE_SIZE_TABLE.items() if v == bps), 0)
    w.write(ss_code, 3)
    w.write(0, 1)
    # utf8 frame number
    for byte in _utf8_number(frame_idx):
        w.write(byte, 8)
    if bs_tail is not None:
        w.write(bs_tail, 16)
    header = w.buf[:]
    w.write(_crc8(header), 8)

    for c in range(block.shape[1]):
        _encode_subframe(w, block[:, c], bps, use_lpc, lpc_order)
    w.align()
    frame_so_far = bytes(w.buf)
    w.write(_crc16(frame_so_far), 16)
    return w.getvalue()


def _utf8_number(value):
    if value < 0x80:
        return [value]
    out = []
    n_extra = 1
    while value >= (1 << (6 + 5 * n_extra)):
        n_extra += 1
    lead_bits = 6 - n_extra
    out.append((0xFF << (lead_bits + 1)) & 0xFF
               | (value >> (6 * n_extra)) & ((1 << lead_bits) - 1))
    for i in range(n_extra - 1, -1, -1):
        out.append(0x80 | ((value >> (6 * i)) & 0x3F))
    return out


def _encode_subframe(w, samples, bps, use_lpc, lpc_order):
    samples = samples.astype(np.int64)
    if np.all(samples == samples[0]):
        w.write(0, 1)
        w.write(0, 6)  # constant
        w.write(0, 1)
        w.write_signed(int(samples[0]), bps)
        return
    candidates = []
    resid = samples
    for order in range(0, 5):
        if order > 0:
            if len(resid) < 2:
                break
            resid = resid[1:] - resid[:-1]
        mean_abs = float(np.abs(resid).mean()) if len(resid) else 0.0
        candidates.append(("fixed", order, resid.copy(), mean_abs))
    best = min(candidates, key=lambda c: c[3])
    lpc = None
    if use_lpc and len(samples) > 2 * lpc_order:
        lpc = _lpc_analyze(samples, lpc_order)
        if lpc is not None:
            _, _, resid_l = lpc
            cost_l = float(np.abs(resid_l).mean()) if len(resid_l) else 0.0
            if cost_l < best[3]:
                best = ("lpc", lpc_order, resid_l, cost_l)
    kind, order, resid = best[0], best[1], best[2]
    w.write(0, 1)
    if kind == "fixed":
        w.write(8 + order, 6)
        w.write(0, 1)  # no wasted bits
        for i in range(order):
            w.write_signed(int(samples[i]), bps)
        _write_residual(w, resid, order, len(samples))
    else:
        coefs, shift, _ = lpc
        w.write(32 + order - 1, 6)
        w.write(0, 1)
        for i in range(order):
            w.write_signed(int(samples[i]), bps)
        w.write(15 - 1, 4)  # precision 15
        w.write_signed(shift, 5)
        for c in coefs:
            w.write_signed(int(c), 15)
        _write_residual(w, resid, order, len(samples))


def _lpc_analyze(samples, order, precision=15):
    """Levinson-Durbin -> quantized coefs + integer residual."""
    x = samples.astype(np.float64)
    autoc = np.array([np.dot(x[:len(x) - k], x[k:]) for k in range(order + 1)])
    if autoc[0] == 0:
        return None
    err = autoc[0]
    a = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(a[:i], autoc[i:0:-1][:i])
        k = acc / err
        a[:i + 1] = np.concatenate([a[:i] - k * a[:i][::-1], [k]])
        err *= (1 - k * k)
        if err <= 0:
            return None
    cmax = np.max(np.abs(a))
    if cmax == 0:
        return None
    shift = min(precision - 1 - max(0, int(np.floor(np.log2(cmax))) + 1), 15)
    if shift <= 0:
        return None
    q = np.clip(np.round(a * (1 << shift)),
                -(1 << (precision - 1)), (1 << (precision - 1)) - 1
                ).astype(np.int64)
    # integer residual exactly as the decoder will reconstruct
    n = len(samples)
    resid = np.empty(n - order, np.int64)
    s = samples
    for i in range(order, n):
        acc = 0
        for j in range(order):
            acc += int(q[j]) * int(s[i - 1 - j])
        resid[i - order] = int(s[i]) - (acc >> shift)
    return q, shift, resid


def _write_residual(w, resid, order, block_size):
    w.write(0, 2)   # rice coding method (4-bit params)
    w.write(0, 4)   # partition order 0: one partition of block_size-order
    mean = float(np.mean(np.abs(resid))) if len(resid) else 0.0
    param = 0
    while (1 << param) < mean and param < 14:
        param += 1
    zz = (np.abs(resid.astype(np.int64)) << 1) - (resid < 0)
    max_q = int(np.max(zz >> param)) if len(zz) else 0
    if max_q > 4096:  # pathological distribution: escape to raw coding
        raw_bits = min(int(np.max(np.abs(resid))).bit_length() + 1, 31)
        w.write(15, 4)  # escape param
        w.write(raw_bits, 5)
        for v in resid:
            w.write_signed(int(v), raw_bits)
        return
    w.write(param, 4)
    for v in zz:
        q = int(v) >> param
        w.write_unary(q)
        if param:
            w.write(int(v) & ((1 << param) - 1), param)
