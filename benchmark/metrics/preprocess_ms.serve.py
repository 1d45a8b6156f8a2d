"""Host ms per served frame inside the benchmark's ``preprocess`` span
around ``Detector.process_image`` (the colour convert and the resize).
None where the traffic sends preprocessed batches."""
UNIT = "ms/img"


def read(rec):
    spans = rec["spans"].get("preprocess")
    if rec["kind"] != "serve" or not spans:
        return None
    return sum(b - a for a, b in spans) / 1e6 / rec["images"]
