"""The fitted stand-in for the confs' ``train.pretrain``:
``synthetic.fit_template_pretrain`` writes a reference-layout checkpoint
that ``appearance.main --set train.pretrain=...`` loads, and its SDF takes
the template body's inside and outside (on the CPU, at ``scale="small"``)."""

import torch

from avatarclip_torch import config as config_mod
from avatarclip_torch.pipelines import appearance, synthetic


def test_fitted_pretrain_loads_and_follows_template(tmp_path):
    fit = synthetic.make_runner(str(tmp_path / "fit"), "small", res=32, device="cpu")
    fit.init_smpl()
    path = str(tmp_path / "pretrain.pth")
    loss = synthetic.fit_template_pretrain(fit, path, steps=60, batch=2048)
    assert loss < 0.1

    conf_path = tmp_path / "small.conf"
    conf_path.write_text(synthetic.make_conf_text(str(tmp_path / "exp"),
                                                  str(tmp_path / "fit" / "views"), "small"))
    conf = config_mod.parse_file(str(conf_path))
    conf.put("train.pretrain", config_mod._parse_value(path))  # as main's --set does
    loaded = appearance.Runner(str(conf_path), mode="none", conf=conf, device="cpu")
    want = fit.fields.state_dict()
    for k, v in loaded.fields.state_dict().items():
        assert torch.equal(v, want[k]), k

    verts, _ = fit._template
    pts = torch.rand(8192, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        target = synthetic.template_sdf(verts, fit._template_normals, pts)
        got = loaded.fields.sdf.sdf(pts)[:, 0]
        init = appearance.Runner(str(conf_path), mode="none", device="cpu").fields.sdf.sdf(pts)[:, 0]
    agree = (torch.sign(got) == torch.sign(target)).float().mean()
    assert agree > 0.97 > (torch.sign(init) == torch.sign(target)).float().mean(), agree
