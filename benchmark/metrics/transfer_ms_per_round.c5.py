"""Device ms of the copy engines' operations (host-to-device and
device-to-host copies, memsets: harness/categories.json's 'transfers') an
ADMM round in the traced stretch: mostly `admm_consensus` placing the
scenario data on the device at each call."""

from benchmark.harness.measures import per, stretch_rounds


def read(run):
    if run.stretch is None or not run.stretch.launches("transfers"):
        return None
    return per(run.stretch.seconds("transfers") * 1e3, stretch_rounds(run))
