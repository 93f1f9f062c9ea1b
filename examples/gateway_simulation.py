"""Run the full gateway state machine against simulated sensors.

The simulator speaks the reference wire protocol (0xA1 sync, 0xD1-0xD3
streams, fault injection) through the same GatewayService that drives real
XBee hardware; completed acquisitions flow through the epoch pipeline and
the history log shows the decoded telemetry + detected peaks.

Run: python examples/gateway_simulation.py
(equivalent to: python -m apda_fft_tpu.gateway --simulate --sensors 2)
"""

import os
import sys

# Runnable from anywhere without installation: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apda_fft_tpu.gateway.__main__ import main

if __name__ == "__main__":
    sys.argv = [sys.argv[0], "--simulate", "--sensors", "2"]
    main()
