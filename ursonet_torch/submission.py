"""The ESA challenge submission, the counterpart of
`ursonet_tpu/submission.py`: `SubmissionWriter` collects per-image
poses and writes `submission_{suffix}.csv`, rows of [filename,
q (scalar first, 4), r (3)], the synthetic test set first and then the
real one, each sorted by filename; `test_and_submit` runs both SPEED
test sets through the serving engine (`evaluate._batched_forward`,
`evaluate.decode_dataset_results`) and writes it. Quaternions are kept
scalar-last inside the port and reordered to scalar-first here.
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Optional

import numpy as np


class SubmissionWriter:
    """Collects per-image results and exports the ESA CSV."""

    def __init__(self):
        self.test_results = []
        self.real_test_results = []

    def _append(self, filename, q, r, real: bool):
        entry = {'filename': filename, 'q': list(q), 'r': list(r)}
        (self.real_test_results if real else self.test_results).append(entry)

    def append_test(self, filename, q, r):
        self._append(filename, q, r, real=False)

    def append_real_test(self, filename, q, r):
        self._append(filename, q, r, real=True)

    def export(self, out_dir: str = '', suffix: Optional[str] = None) -> str:
        sorted_test = sorted(self.test_results, key=lambda k: k['filename'])
        sorted_real = sorted(self.real_test_results,
                             key=lambda k: k['filename'])
        if suffix is None:
            suffix = datetime.now().strftime("%Y%m%d-%H%M")
        path = os.path.join(out_dir, f"submission_{suffix}.csv")
        with open(path, 'w') as f:
            w = csv.writer(f, lineterminator='\n')
            for result in sorted_test + sorted_real:
                w.writerow([result['filename'],
                            *(result['q'] + result['r'])])
        print(f"Submission saved to {path}.")
        return path


def test_and_submit(engine, dataset_virtual, dataset_real,
                    out_dir: str = '', suffix: Optional[str] = None) -> str:
    """Serve both SPEED test sets (either may be None or empty) and write
    the submission; returns its path."""
    from ursonet_torch.evaluate import _batched_forward, \
        decode_dataset_results

    writer = SubmissionWriter()
    for dataset, append in ((dataset_virtual, writer.append_test),
                            (dataset_real, writer.append_real_test)):
        if dataset is None or len(dataset.image_ids) == 0:
            continue
        ids = list(dataset.image_ids)
        outputs = _batched_forward(engine, dataset, ids)
        locs, qs = decode_dataset_results(outputs, engine.config, dataset)
        for n, i in enumerate(ids):
            filename = os.path.basename(dataset.image_info[i]['path'])
            q = np.asarray(qs[n], np.float64)
            # scalar-last (internal) -> scalar-first (ESA)
            append(filename, [q[3], q[0], q[1], q[2]],
                   list(np.asarray(locs[n], np.float64)))
    return writer.export(out_dir, suffix)
