"""Re-score a computation-reuse schedule JSON.

The counterpart of soda_tpu/tools/calc_cost.py (the reference's
src/calc-cost helper, calc-cost:1-17), over the port's own copy of the
schedules (optimization/cr_schedules.py): reads a schedule tree (the
external scheduler's output format) plus the operand attributes from
stdin and prints its (num_ops, total_distance) cost.

    python -m soda_tpu_torch.tools.calc_cost < schedule.json

Input JSON: {"schedule": {...}, "aattrs": [...] | null}
  - "schedule": nested {"left": <tree|int>, "right": ..., "distance": d}
Output: {"num_ops": N, "total_distance": D}
"""

import json
import sys

from soda_tpu_torch.optimization import cr_schedules as cr


def main() -> int:
  payload = json.load(sys.stdin)
  schedule_json = payload.get('schedule', payload)
  null_aattr = payload.get('aattrs') is None
  schedule = cr.schedule_from_json(schedule_json, null_aattr)
  json.dump({'num_ops': schedule.num_ops,
             'total_distance': schedule.total_distance}, sys.stdout)
  sys.stdout.write('\n')
  return 0


if __name__ == '__main__':
  sys.exit(main())
