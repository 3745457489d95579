"""The two detection examples, run on the port on the CPU (as
`test_torch_examples.py`'s docstring says), with the arguments and gates
`tests/test_examples.py` gives `mxtpu`: `ssd/ssd_mini.py` (the MultiBox
family: priors, targets, detections; it ends on its own assertion of at
least one detection) and `rcnn/faster_rcnn_mini.py` (MultiProposal and
ROIPooling; FINAL_ROI_ACCURACY above 0.5).  Each takes about 5 s alone
on the CPU, so both run whole here; `chip_smoke.py`'s det phase runs
them at their defaults on the card."""
from test_torch_examples import final_metric, run_example


def test_ssd_multibox_family():
    out = run_example("ssd/ssd_mini.py", "--epochs", "2",
                      "--det-threshold", "0.05")
    assert "detections per image" in out


def test_faster_rcnn():
    out = run_example("rcnn/faster_rcnn_mini.py", "--epochs", "4")
    assert final_metric(out, "FINAL_ROI_ACCURACY") > 0.5
