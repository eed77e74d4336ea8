"""GenEval generation harness (port of bitdance_tpu/eval/geneval.py; the
reference's eval/eval_geneval.py:11-62).

The GenEval layout per prompt: ``NNNNN/metadata.jsonl`` (the input line
verbatim), ``samples/000i.png`` and ``grid.png``. The reference's
configuration: cfg 13.0, 50 steps, 1024^2, the long prompts
(scripts/eval/eval_bitdance_14b_64x.sh:21-30).

    python -m bitdance_tpu_torch.eval.geneval --model_path models/BitDance-14B-64x \\
        --data_path eval_assets/geneval/evaluation_metadata_long.jsonl
"""

from __future__ import annotations

import json
import os
import sys

from bitdance_tpu_torch.eval.base import BaseEvaluator, harness_main, save_grid, save_images


class GenevalEvaluator(BaseEvaluator):
    def build_dataset(self, data_path: str):
        datasets = []
        with open(data_path) as f:
            for i, line in enumerate(f):
                rec = json.loads(line)
                datasets.append({"id": i, "prompt": rec["prompt"], "metadata": line})
        self.datasets = self.shard(datasets)

    def eval(self, data_path: str, save_dir: str, guidance_scale: float = 13.0,
             num_sampling_steps: int = 50, image_size=(1024, 1024),
             max_prompts: int = 0):
        os.makedirs(save_dir, exist_ok=True)
        self.build_dataset(data_path)
        if max_prompts:
            self.datasets = self.datasets[:max_prompts]
        for data in self.datasets:
            save_path = os.path.join(save_dir, f"{data['id']:05d}")
            os.makedirs(os.path.join(save_path, "samples"), exist_ok=True)
            with open(os.path.join(save_path, "metadata.jsonl"), "w") as f:
                f.write(data["metadata"])
            images = self.model.generate(
                data["prompt"], height=image_size[0], width=image_size[1],
                num_sampling_steps=num_sampling_steps, guidance_scale=guidance_scale,
                num_images=4, seed=self.seed)
            save_images(images, [os.path.join(save_path, f"samples/{i:04d}.png")
                                 for i in range(images.shape[0])])
            save_grid(images, os.path.join(save_path, "grid.png"), nrow=2)
        self.logger.info(f"rank {self.rank}: wrote {len(self.datasets)} dirs")


def main(argv=None, tokenizer=None) -> int:
    return harness_main(GenevalEvaluator, "GenEval generation",
                        "eval_assets/geneval/evaluation_metadata.jsonl", "results/geneval",
                        13.0, argv, tokenizer)


if __name__ == "__main__":
    sys.exit(main())
